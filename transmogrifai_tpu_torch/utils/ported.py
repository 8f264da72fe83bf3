"""The error every entry point of a part that is not ported yet raises."""
from __future__ import annotations

__all__ = ["not_ported"]


def not_ported(what: str, module: str) -> NotImplementedError:
    """``NotImplementedError`` saying that ``what`` waits for the port of
    the JAX package's ``module`` (a path under ``transmogrifai_tpu/``)."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: it waits for "
        f"transmogrifai_tpu/{module}")
