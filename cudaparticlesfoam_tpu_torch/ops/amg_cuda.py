"""Wrappers of the AMG-CG pressure solve's CUDA kernels (``csrc/amg.cu``).

* :func:`fv_matvec` -> ``fv_matvec_kernel``: ``fv.matvec`` (level 0's
  lower/upper, x [n] or [n, k], k <= 3) and a V-cycle level's symmetric
  matvec;
* :func:`amg_down` -> ``amg_down_kernel``: one level on the way down
  (pre-smooth, residual, restriction);
* :func:`amg_up` -> ``amg_up_kernel``: one level on the way up
  (prolongation, post-smooth), with ``valid`` the shard's form;
* :func:`amg_coarsest` -> ``amg_coarsest_kernel``: the coarsest level's
  damped-Jacobi sweeps in one launch.

None replaces a Pallas kernel: JAX leaves the solve to XLA's fusion
(``cudaparticlesfoam_tpu/models/fv.py:420-431``, ``:537-570``).  A wrapper
given CPU tensors runs the plain version from ``ops/amg.py``; given CUDA
tensors it launches the kernel on the current stream of the tensors' card,
or raises; any other device raises.  Each wrapper counts its launches in
``.launches``; a launch into a CUDA graph being captured counts once, as
one launch, however often the graph is replayed.
"""

from __future__ import annotations

import torch

from .amg import (COARSEST_SWEEPS, OMEGA, RowPlan, coarsest_plain, down_plain, int32_index,
                  matvec_plain, up_plain)
from .fused_cuda import _SUFFIX, _check, _entry, _raise_on, _stream_ptr

# must match csrc/amg.cu: above it the coarsest level sweeps in global memory
COARSEST_SMEM_BYTES = 48 * 1024


def _check_vec(name, t, n, like):
    """``t`` a contiguous [n] tensor of ``like``'s dtype on its device."""
    _check(name, t, dtype=like.dtype, shape=(n,), device=like.device)


def _device(plan: RowPlan, x, *plans):
    """The device to run on: 'cpu', or 'cuda' once the plans lie there too."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"the AMG kernels take float32 or float64, got {x.dtype}")
    dev = x.device
    for p in (plan,) + plans:
        if p.offsets.device != dev:
            raise ValueError(f"a row plan is on {p.offsets.device}, the values on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no AMG kernel for tensors on {dev}")
    return dev


def _launch(dev, name, dtype, *args):
    """Launch entry ``name`` on the current stream of ``dev`` (made the
    current device for the call if it is not)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        _raise_on(_entry(name, dtype)(*args, _stream_ptr(dev)), name)
        return
    with torch.cuda.device(dev):
        _raise_on(_entry(name, dtype)(*args, _stream_ptr(dev)), name)


def _plan_args(plan: RowPlan):
    return plan.offsets.data_ptr(), plan.pos.data_ptr(), plan.col.data_ptr(), plan.n_src


def fv_matvec(plan: RowPlan, diag, upper, lower, x):
    """``diag*x + sum_row coef*x[col]`` over ``plan``'s rows (``ops/amg.row_plan``
    of the faces): ``upper`` [nf] the owner rows' coefficients, ``lower``
    [nf] the neighbour rows' (the same tensor for a symmetric level), x [n]
    or [n, k] with k <= 3.  Returns a new tensor like x."""
    dev = _device(plan, x)
    n, nf = plan.n, plan.n_src
    k = 1 if x.dim() == 1 else x.shape[1]
    if x.dim() not in (1, 2) or x.shape[0] != n or not 1 <= k <= 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [{n}] or [{n}, k <= 3] tensor, "
                         f"got {tuple(x.shape)}")
    _check_vec("diag", diag, n, x)
    _check_vec("upper", upper, nf, x)
    _check_vec("lower", lower, nf, x)
    if dev.type == "cpu":
        return matvec_plain(plan, diag, upper, lower, x)
    y = torch.empty_like(x)
    if n:
        _launch(dev, "fv_matvec", x.dtype, n, k, *_plan_args(plan), diag.data_ptr(),
                upper.data_ptr(), lower.data_ptr(), x.data_ptr(), y.data_ptr())
        fv_matvec.launches += 1
    return y


fv_matvec.launches = 0


def amg_down(rows: RowPlan, aggs: RowPlan, diag, off, r, omega=OMEGA):
    """One V-cycle level on the way down: x = omega r / d, r1 = r - A x
    (A = diag + ``off`` over ``rows``), and the coarse residual
    ``rc[c] = sum_{i in agg c} r1[i]`` over ``aggs`` (``ops/amg.agg_plan``).
    Returns rc [aggs.n]."""
    dev = _device(rows, r, aggs)
    n = rows.n
    _check_vec("r", r, n, r)
    _check_vec("diag", diag, n, r)
    _check_vec("off", off, rows.n_src, r)
    if aggs.n_src != n:
        raise ValueError(f"the aggregation plan restricts {aggs.n_src} rows, not {n}")
    if dev.type == "cpu":
        return down_plain(rows, aggs, diag, off, r, omega)
    rc = torch.empty(aggs.n, dtype=r.dtype, device=dev)
    if aggs.n:
        _launch(dev, "amg_down", r.dtype, aggs.n, aggs.offsets.data_ptr(), aggs.col.data_ptr(),
                *_plan_args(rows), diag.data_ptr(), off.data_ptr(), r.data_ptr(), omega,
                rc.data_ptr())
        amg_down.launches += 1
    return rc


amg_down.launches = 0


def amg_up(rows: RowPlan, diag, off, r, agg, xc, valid=None, omega=OMEGA):
    """One V-cycle level on the way up: x' = omega r / d + xc[agg] (times
    ``valid`` [n] on a shard, whose ``agg`` is clipped into xc), then
    x' + omega (r - A x') / d.  ``agg`` is int32 or int64 [n]; int64 is
    copied to int32 once per tensor.  Returns x [n]."""
    dev = _device(rows, r)
    n = rows.n
    _check_vec("r", r, n, r)
    _check_vec("diag", diag, n, r)
    _check_vec("off", off, rows.n_src, r)
    if valid is not None:
        _check_vec("valid", valid, n, r)
    if not (torch.is_tensor(agg) and agg.dim() == 1 and agg.shape[0] == n
            and agg.device == dev and agg.dtype in (torch.int32, torch.int64)):
        raise ValueError(f"agg must be an int32 or int64 [{n}] tensor on {dev}")
    if not (torch.is_tensor(xc) and xc.dim() == 1 and xc.dtype == r.dtype and xc.device == dev
            and xc.is_contiguous()):
        raise ValueError(f"xc must be a contiguous 1-d {r.dtype} tensor on {dev}")
    if dev.type == "cpu":
        return up_plain(rows, diag, off, r, agg, xc, valid, omega)
    x = torch.empty_like(r)
    if n:
        a32 = int32_index(agg)
        _launch(dev, "amg_up", r.dtype, n, *_plan_args(rows), diag.data_ptr(), off.data_ptr(),
                r.data_ptr(), omega, a32.data_ptr(),
                None if valid is None else valid.data_ptr(), xc.data_ptr(), x.data_ptr())
        amg_up.launches += 1
    return x


amg_up.launches = 0


def amg_coarsest(rows: RowPlan, diag, off, r, omega=OMEGA, sweeps=COARSEST_SWEEPS):
    """The coarsest level: x = omega r / d, then ``sweeps`` damped-Jacobi
    sweeps, in one launch of one block.  Returns x [n]."""
    dev = _device(rows, r)
    n = rows.n
    _check_vec("r", r, n, r)
    _check_vec("diag", diag, n, r)
    _check_vec("off", off, rows.n_src, r)
    if dev.type == "cpu":
        return coarsest_plain(rows, diag, off, r, omega, sweeps)
    x = torch.empty_like(r)
    if n:
        scratch = (torch.empty_like(r) if 2 * n * r.element_size() > COARSEST_SMEM_BYTES
                   else None)
        _launch(dev, "amg_coarsest", r.dtype, n, *_plan_args(rows), diag.data_ptr(),
                off.data_ptr(), r.data_ptr(), omega, int(sweeps), x.data_ptr(),
                None if scratch is None else scratch.data_ptr())
        amg_coarsest.launches += 1
    return x


amg_coarsest.launches = 0

WRAPPERS = (fv_matvec, amg_down, amg_up, amg_coarsest)

