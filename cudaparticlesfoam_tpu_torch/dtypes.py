"""Precision and device policy for the PyTorch/CUDA port.

* ``float32`` is the production dtype, on the CPU and on CUDA alike.
* ``float64`` is allowed everywhere for parity runs: the CUDA kernels are
  instantiated for ``double`` too, so the card can replay the committed
  f64 golden anchors.

Unlike the JAX package there is no global x64 switch: every builder takes
an explicit ``dtype`` and ``device``.  The device defaults to the card
(``"cuda"``): a builder called without one allocates there, and raises
where torch has no usable CUDA; CPU runs (the tests, the rehearsal) pass
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

_FLOATS = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def canonical_float(dtype=None) -> torch.dtype:
    """Resolve a user dtype (torch, numpy or string; None = float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype in (torch.float32, torch.float64):
            return dtype
        raise ValueError(f"unsupported float dtype {dtype}; use float32/float64")
    nd = np.dtype(dtype)
    if nd not in _FLOATS:
        raise ValueError(f"unsupported float dtype {nd}; use float32/float64")
    return _FLOATS[nd]


def numpy_float(dtype=None) -> np.dtype:
    """The numpy twin of :func:`canonical_float`."""
    return np.dtype(str(canonical_float(dtype)).replace("torch.", ""))


def canonical_device(device=None) -> torch.device:
    """None = the card (``"cuda"``, never a quiet fall back to the CPU);
    anything else as given (``"cpu"``, ``"cuda:1"``, ``torch.device``)."""
    return torch.device("cuda" if device is None else device)


def run_device(device=None) -> torch.device:
    """The device of a driver run (:func:`canonical_device`): on a CUDA
    device it raises where torch has no usable CUDA, and resets the peak
    memory counter the run reports."""
    device = canonical_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no usable CUDA device for device={str(device)!r} (this "
                               "torch has none); pass device='cpu' (CLI: --device cpu)")
        torch.cuda.reset_peak_memory_stats(device)
    return device
