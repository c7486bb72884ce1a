"""Wrappers of the hand-written CUDA kernels (the port's counterpart of
``cudaparticlesfoam_tpu/ops/fused_pallas.py``).

* :func:`stream_cycle` -> ``stream_kernel`` (``csrc/stream.cu``): the
  TPU stream kernels A / hop H / B / B2 in their packed and transposed
  variants (``fused_pallas.py`` kernels 1-9), fused into one per-lane
  kernel that loads neighbour rows itself.
* :func:`rare_resolve` -> ``rare_kernel`` (``csrc/rare.cu``): the XLA rare
  stage (``fused._rare_stage(_packed)`` with ``_walk_mega`` and
  ``_reflect_mega``).

A wrapper given CPU tensors runs the plain version from ``ops/fused.py``;
given CUDA tensors it launches the kernel on the current stream, or
raises.  Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused import LAYOUT_TET, rare_plain, stream_plain

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, t, *, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tab_m(tab, m):
    if m.dtype not in _SUFFIX:
        raise TypeError(f"m must be float32 or float64, got {m.dtype}")
    if m.dim() != 2:
        raise ValueError(f"m must be [n, {LAYOUT_TET.width}], got {tuple(m.shape)}")
    n, dev = m.shape[0], m.device
    _check("m", m, dtype=m.dtype, shape=(n, LAYOUT_TET.width), device=dev)
    if tab.dim() != 2:
        raise ValueError(f"tab must be [nt, {LAYOUT_TET.row_w}], got {tuple(tab.shape)}")
    _check("tab", tab, dtype=m.dtype, shape=(tab.shape[0], LAYOUT_TET.row_w), device=dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, dev


def _stream_ptr(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def stream_cycle(tab, m, xi, pending, *, dt, sigma, use_adv, use_brown,
                 bounce_on, esc_on, n_hops):
    """Stream section of one cycle (K1 + K2), in place on ``m`` [n, 32];
    writes the rare-stage flags into ``pending`` [n] uint8.  ``xi`` [n, 3]
    (same dtype) is required iff ``use_brown``."""
    n, dev = _check_tab_m(tab, m)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    if use_brown:
        _check("xi", xi, dtype=m.dtype, shape=(n, 3), device=dev)
    if not 0 <= int(n_hops) <= 8:
        raise ValueError(f"n_hops must be in 0..8, got {n_hops}")
    kw = dict(dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown),
              bounce_on=bool(bounce_on), esc_on=bool(esc_on), n_hops=int(n_hops))
    if dev.type == "cpu":
        stream_plain(tab, m, xi, pending, **kw)
        return
    if n == 0:
        return
    lib = _build.library()
    fn = getattr(lib, f"cpf_stream_{_SUFFIX[m.dtype]}")
    err = fn(tab.data_ptr(), m.data_ptr(), xi.data_ptr() if use_brown else None,
             pending.data_ptr(), n, dt, sigma, int(kw["use_adv"]),
             int(kw["use_brown"]), int(kw["bounce_on"]), int(kw["esc_on"]),
             kw["n_hops"], _stream_ptr(dev))
    _build.check(lib, err, "stream_kernel")
    stream_cycle.launches += 1


stream_cycle.launches = 0


def rare_resolve(tab, m, pending, bd_escape, *, max_hops, max_bounces,
                 reflect_wall):
    """Rare stage (K7), in place on ``m``: every lane with ``pending`` set
    runs the bounded walk (max(2, max_hops) hops) and, with
    ``reflect_wall``, up to ``max_bounces`` specular reflections, each
    re-walk bounded by the default 50 hops; ``bd_escape`` [nbd] bool marks
    absorbing faces.  The kernel covers all n lanes and returns at once
    where the flag is 0 (no host sync, no compaction)."""
    n, dev = _check_tab_m(tab, m)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    _check("bd_escape", bd_escape, dtype=torch.bool, shape=(bd_escape.shape[0],),
           device=dev)
    kw = dict(max_hops=int(max_hops), max_bounces=int(max_bounces),
              reflect_wall=bool(reflect_wall))
    if dev.type == "cpu":
        rare_plain(tab, m, pending, bd_escape, **kw)
        return
    if n == 0:
        return
    lib = _build.library()
    fn = getattr(lib, f"cpf_rare_{_SUFFIX[m.dtype]}")
    err = fn(tab.data_ptr(), m.data_ptr(), pending.data_ptr(),
             bd_escape.data_ptr(), n, bd_escape.shape[0], kw["max_hops"],
             kw["max_bounces"], int(kw["reflect_wall"]), _stream_ptr(dev))
    _build.check(lib, err, "rare_kernel")
    rare_resolve.launches += 1


rare_resolve.launches = 0
