"""Search journal: append-only JSONL checkpointing of a model search.

The port's copy of ``transmogrifai_tpu/runtime/journal.py``, in its file
layout, header and entry keys, so a journal written by either package
resumes a search of the other. The unit of the journal is the unit the
search dispatches: one **family evaluation** (a ``(family,
candidate-subset, rung)`` metric matrix, ``len(cands) x folds``
candidate-fold fits).

- **Append-only JSONL, fsync'd per record.** A crash can at worst
  truncate the final line; a torn tail is dropped on replay (the record
  re-runs, never mis-parses).
- **Schema-versioned, fingerprint-keyed.** The header pins a SHA-1 over
  the candidate pool (family class and grid), the validator's split
  protocol (folds, seed, stratification, racing schedule) and the
  training arrays' bytes. A journal replays only into the same search;
  anything else is rotated aside as ``.stale``.
- **Bit-exact replay.** Metric vectors round-trip through JSON ``repr``
  (exact for IEEE doubles, NaN included), and every pruning and ranking
  decision downstream of the metrics is deterministic, so a resumed
  search picks the identical winner while dispatching none of the
  journaled entries (``runtime.telemetry.dispatch_log``).

A training matrix on the card is fingerprinted by its host bytes in its
own dtype: the validator copies it to the host once, and only when the
search has a ``checkpoint_dir``. A float32 card search and a float64 CPU
search therefore never share a journal, as their metrics differ.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_log = logging.getLogger(__name__)

__all__ = ["SearchJournal", "search_fingerprint", "read_journal",
           "JOURNAL_VERSION", "JOURNAL_NAME"]

JOURNAL_VERSION = 1
JOURNAL_NAME = "search-journal.jsonl"


def search_fingerprint(pool, validator_params: dict,
                       X: np.ndarray, y: np.ndarray) -> str:
    """SHA-1 identity of one search: candidate pool (family class names
    + grids — uids deliberately excluded, they differ across
    processes), validation protocol, and the training arrays' bytes.
    Two runs with the same fingerprint walk the same fold masks, the
    same rung schedule and the same candidate pool, so journaled
    metrics are interchangeable between them. A tensor ``X`` is hashed
    by its host copy in its own dtype."""
    h = hashlib.sha1()
    h.update(f"v{JOURNAL_VERSION}".encode())
    pool_desc = [
        (type(est).__name__,
         json.dumps(list(grid) or [{}], sort_keys=True, default=str))
        for est, grid in pool]
    h.update(json.dumps(pool_desc, sort_keys=True).encode())
    h.update(json.dumps(validator_params, sort_keys=True,
                        default=str).encode())
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    X = np.ascontiguousarray(np.asarray(X))
    y = np.ascontiguousarray(np.asarray(y))
    h.update(f"{X.shape}:{X.dtype}:{y.shape}:{y.dtype}".encode())
    h.update(X.tobytes())
    h.update(y.tobytes())
    return h.hexdigest()


def _entry_key(family_key: str, rung_label: str) -> Tuple[str, str]:
    return (family_key, rung_label)


class SearchJournal:
    """One search's ledger under ``<checkpoint_dir>/search-journal
    .jsonl``. Life cycle: ``open(fingerprint)`` -> ``lookup``/
    ``record`` during the search -> ``close()``."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, JOURNAL_NAME)
        self._entries: Dict[Tuple[str, str], dict] = {}
        self._fh = None
        self._lock = threading.Lock()
        self.fingerprint: Optional[str] = None
        #: entries replayed from disk at open() (resume telemetry)
        self.replayed = 0
        #: mesh topology of the run that WROTE the header (metadata,
        #: deliberately outside the fingerprint — see open())
        self.recorded_topology: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------
    def open(self, fingerprint: str,
             topology: Optional[dict] = None) -> "SearchJournal":
        """``topology`` describes the devices this run searches on (the
        port's single card: ``{"devices": 1, "mesh": None}``). It is
        header metadata, outside the fingerprint, as in the JAX package,
        whose metric matrices do not depend on the device count."""
        os.makedirs(self.directory, exist_ok=True)
        self.fingerprint = fingerprint
        existing, header = self._read_existing()
        if header is not None and header.get("fingerprint") != fingerprint:
            stale = self.path + ".stale"
            _log.warning(
                "journal at %s was written by a different search "
                "(fingerprint %s != %s); rotating it to %s and starting "
                "fresh", self.path,
                (header.get("fingerprint") or "?")[:12], fingerprint[:12],
                stale)
            os.replace(self.path, stale)
            existing = []
            header = None
        if header is not None:
            self.recorded_topology = header.get("topology")
            if topology is not None and self.recorded_topology is not None \
                    and self.recorded_topology != topology:
                _log.info(
                    "journal %s was recorded on topology %s; resuming on "
                    "%s: metric matrices do not depend on the device "
                    "count, so the resumed search replays them unchanged",
                    self.path, self.recorded_topology, topology)
        self._entries = {
            _entry_key(e["family"], e["rung"]): e for e in existing}
        self.replayed = len(self._entries)
        self._fh = open(self.path, "a", encoding="utf-8")
        if header is None:
            head = {"kind": "header", "v": JOURNAL_VERSION,
                    "fingerprint": fingerprint}
            if topology is not None:
                head["topology"] = topology
            self.recorded_topology = topology
            self._write_line(head)
        return self

    def _read_existing(self):
        """(entries, header) from disk; a torn final line (crash mid-
        append) is dropped, and a journal from a NEWER schema is
        refused rather than mis-replayed."""
        if not os.path.exists(self.path):
            return [], None
        header, entries = None, []
        with open(self.path, encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    _log.warning("journal %s: dropping torn record at "
                                 "line %d (crash mid-append)",
                                 self.path, i + 1)
                    break
                if rec.get("kind") == "header":
                    if rec.get("v", 0) > JOURNAL_VERSION:
                        raise ValueError(
                            f"journal {self.path} uses schema v{rec['v']}; "
                            f"this build reads up to v{JOURNAL_VERSION}")
                    header = rec
                elif rec.get("kind") == "eval":
                    entries.append(rec)
        return entries, header

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- records -----------------------------------------------------------
    def _write_line(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def record(self, family_key: str, rung_label: str,
               cands: Sequence[int], metrics: Sequence[Sequence[float]],
               folds: int) -> None:
        """Append one completed family evaluation: ``metrics[i]`` is
        candidate ``cands[i]``'s per-fold metric vector. Fsync'd before
        returning — once ``record`` returns, a kill cannot lose the
        work."""
        rec = {"kind": "eval", "family": family_key, "rung": rung_label,
               "cands": [int(c) for c in cands],
               "metrics": [[float(v) for v in row] for row in metrics],
               "folds": int(folds)}
        with self._lock:
            if self._fh is None:
                raise RuntimeError("journal is not open")
            self._entries[_entry_key(family_key, rung_label)] = rec
            self._write_line(rec)

    def lookup(self, family_key: str, rung_label: str,
               cands: Sequence[int]
               ) -> Optional[List[List[float]]]:
        """The journaled per-candidate metric vectors for this exact
        (family, rung, candidate-subset) — None when absent or when the
        candidate subset disagrees (a half-changed search must re-run,
        not mis-replay)."""
        with self._lock:
            rec = self._entries.get(_entry_key(family_key, rung_label))
        if rec is None:
            return None
        if [int(c) for c in cands] != rec["cands"]:
            return None
        return [list(row) for row in rec["metrics"]]

    def entries(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._entries.values()]


def read_journal(directory: str) -> dict:
    """Inspection summary of a checkpoint dir: header, entry rows, and
    the fold-fit equivalents a resume would skip."""
    path = os.path.join(directory, JOURNAL_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {JOURNAL_NAME} under {directory!r} — not a search "
            f"checkpoint directory")
    j = SearchJournal(directory)
    entries, header = j._read_existing()
    saved = sum(len(e["cands"]) * e["folds"] for e in entries)
    return {
        "path": path,
        "fingerprint": (header or {}).get("fingerprint"),
        "version": (header or {}).get("v"),
        # the writing run's devices (metadata only)
        "recordedTopology": (header or {}).get("topology"),
        "entries": entries,
        "families": sorted({e["family"] for e in entries}),
        "rungs": sorted({e["rung"] for e in entries}),
        "resumeSavedFoldFits": saved,
    }
