"""Device and dtype policy of the PyTorch port.

Counterpart of the device half of ``transmogrifai_tpu/utils/jax_setup.py``.
The port computes in float32 on a CUDA card, as the JAX package computes on
an accelerator, and in float64 on the CPU, matching the JAX tests, which run
under ``jax_enable_x64``. Every public entry point of the port takes a
``device`` argument that defaults to ``"cuda"``; without a card it raises
instead of carrying on on the CPU, so a CPU run is always one the caller
asked for.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "working_dtype", "take_rows"]

# a float32 product on the card must stay float32, not TF32 (about three
# decimal digits): split gains and metrics are compared across devices
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is visible, or if it is neither CUDA nor the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "transmogrifai_tpu_torch runs on CUDA by default and no "
                "CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    return dev


def working_dtype(device: torch.device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64


def take_rows(data, idx):
    """Rows ``idx`` (an integer array) of a numpy array or of a tensor; a
    tensor's rows are gathered on its own device."""
    if isinstance(data, torch.Tensor):
        return data[torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                    device=data.device)]
    return data[idx]
