"""Build/version info embedded in saved artifacts.

The port's copy of ``transmogrifai_tpu/utils/version.py`` (reference
VersionInfo, utils/src/main/scala/com/salesforce/op/utils/version/
VersionInfo.scala, which bakes the git sha into the jar): resolved lazily
from the repository (or the ``TX_GIT_SHA`` override) and written into
``op-model.json``. Outside a git checkout the sha and branch are None.
"""
from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass
from typing import Optional

__all__ = ["VersionInfo", "version_info"]

VERSION = "0.1.0"


@dataclass(frozen=True)
class VersionInfo:
    version: str
    git_sha: Optional[str] = None
    git_branch: Optional[str] = None

    def to_json(self) -> dict:
        return {"version": self.version, "gitSha": self.git_sha,
                "gitBranch": self.git_branch}


def _git(*args: str) -> Optional[str]:
    try:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        out = subprocess.run(["git", *args], cwd=repo, capture_output=True,
                             text=True, timeout=5)
        return out.stdout.strip() or None
    except Exception:
        return None


def version_info() -> VersionInfo:
    sha = os.environ.get("TX_GIT_SHA") or _git("rev-parse", "HEAD")
    branch = _git("rev-parse", "--abbrev-ref", "HEAD")
    return VersionInfo(version=VERSION, git_sha=sha, git_branch=branch)
