"""Wrappers of the AMG-CG pressure solve's CUDA kernels (``csrc/amg.cu``).

* :func:`fv_matvec` -> ``fv_matvec_kernel``: ``fv.matvec`` (level 0's
  lower/upper, x [n] or [n, k], k <= 3) and a V-cycle level's symmetric
  matvec;
* :func:`amg_down` -> ``amg_down_kernel``: one level on the way down
  (pre-smooth, residual, restriction);
* :func:`amg_up` -> ``amg_up_kernel``: one level on the way up
  (prolongation, post-smooth), with ``valid`` the shard's form;
* :func:`amg_tail` -> ``amg_tail_kernel``: the levels of at most
  :data:`TAIL_ROWS` rows and the coarsest, down and back up, in one launch
  of one cluster of 16 thread blocks, from a plan made once per hierarchy
  (``ops/amg_tail.py``); a tail of one level is the coarsest alone.

None replaces a Pallas kernel: JAX leaves the solve to XLA's fusion
(``cudaparticlesfoam_tpu/models/fv.py:420-431``, ``:537-570``).  A wrapper
given CPU tensors runs the plain version from ``ops/amg.py``; given CUDA
tensors it launches the kernel on the current stream of the tensors' card,
or raises; any other device raises.  Each wrapper counts its launches in
``.launches``; a launch into a CUDA graph being captured counts once, as
one launch, however often the graph is replayed.
"""

from __future__ import annotations

import ctypes

import torch

from . import amg_tail as plans
from .amg import (COARSEST_SWEEPS, MAX_TAIL_LEVELS, OMEGA, RowPlan, down_plain, int32_index,
                  matvec_plain, tail_plain, tail_start, up_plain)
from .fused_cuda import _SUFFIX, _check, _entry, _raise_on, _stream_ptr

# A level of at most TAIL_ROWS rows runs in the tail (ops/amg.py:tail_start);
# 0 leaves the coarsest alone there.  Fixed from the crossover of a level's
# amg_down + amg_up against the tail's two phases at that level
# (chip_smoke.py 14a, PERF.md).
TAIL_ROWS = 8_192
# The tail's levels from the first of at most TAIL_BLOCK0_ROWS rows down run
# in block 0 alone (ops/amg_tail.py); chip_smoke.py 14a times 512 and 1024.
TAIL_BLOCK0_ROWS = 512
# must match csrc/amg.cu: the tail's cluster of TAIL_BLOCKS blocks of at
# most TAIL_THREADS threads, what it keeps in their shared memory
TAIL_BLOCKS = plans.TAIL_BLOCKS
TAIL_THREADS = 512
TAIL_SMEM_BYTES = 230_912       # the opt-in 227 KB less 1.5 KB for the static part


class TailLevel(ctypes.Structure):
    """``csrc/amg.cu:TailLevel``: one level of the tail."""
    _fields_ = ([("diag", ctypes.c_void_p), ("off", ctypes.c_void_p),
                 ("valid", ctypes.c_void_p)]
                + [(name, ctypes.c_int32) for name in (
                    "n", "stage", "cap_rows", "cap_terms", "base", "seg", "copy",
                    "toff", "addr", "moff", "mem", "poff", "pmem", "grow", "ldst", "tslot",
                    "cpos", "st", "coef", "sdiag", "svalid", "sv", "sr", "ss", "lvalid", "r",
                    "v", "pad")])


class TailParams(ctypes.Structure):
    """``csrc/amg.cu:TailParams``: the kernel's one argument, passed by
    value (a CUDA graph captures it whole)."""
    _fields_ = ([("r_top", ctypes.c_void_p), ("x_out", ctypes.c_void_p),
                 ("xs", ctypes.c_void_p), ("blob", ctypes.c_void_p), ("prog", ctypes.c_void_p),
                 ("stamps", ctypes.c_void_p), ("omega", ctypes.c_double)]
                + [(name, ctypes.c_int32) for name in (
                    "levels", "cluster", "sweeps", "xb", "r1", "sp", "lower", "prog_local",
                    "prog_stretch")]
                + [("lv", TailLevel * MAX_TAIL_LEVELS)])


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


def _on(dev, fn):
    """fn() with ``dev`` the current device (made so for the call if it is
    not)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn()
    with torch.cuda.device(dev):
        return fn()


def _launch(dev, name, dtype, *args):
    """Launch entry ``name`` on the current stream of ``dev``."""
    _on(dev, lambda: _raise_on(_entry(name, dtype)(*args, _stream_ptr(dev)), name))


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


def tail_layout(plan: plans.TailPlan, elem: int, valid: bool = False) -> plans.TailLayout:
    """Where the tail of ``plan`` keeps its vectors and staged segments in a
    block's shared memory with ``elem``-byte values (and the
    prolongation's valid).  Raises, with the numbers, where its vectors do
    not fit in ``TAIL_SMEM_BYTES``, and where a tail whose top has at most
    ``TAIL_ROWS`` rows cannot stage every level (:func:`tail_split` then
    starts a V-cycle's tail lower).  Only a larger tail, which no V-cycle
    takes, reads the levels that do not fit from global memory
    (``layout.stage``)."""
    lay = plans.layout(plan, elem, valid, TAIL_SMEM_BYTES, TAIL_THREADS)
    if plan.sizes[0] <= TAIL_ROWS and not all(lay.stage):
        raise ValueError(
            f"the tail of levels {list(plan.sizes)} (a top of at most TAIL_ROWS = {TAIL_ROWS} "
            f"rows) needs {lay.full} B of shared memory a block to stage every level "
            f"({elem} B values, {lay.vectors} B of them vectors), more than its "
            f"{TAIL_SMEM_BYTES} B; staged: {list(lay.stage)}")
    return lay


def tail_split(rows, aggs, prolong, elem: int) -> int:
    """The first level of a V-cycle's tail (``fv.vcycle_levels``):
    ``ops/amg.tail_start`` at ``TAIL_ROWS``, moved down a level at a time
    while the tail from there cannot stage every level in a block's shared
    memory with ``elem``-byte values (:func:`tail_layout` raises: float64
    from 7,750 rows on the TJunction), so that the tail a V-cycle launches
    is always staged whole; the levels passed run ``amg_down`` /
    ``amg_up``."""
    t = tail_start([p.n for p in rows], TAIL_ROWS)
    valid = any(v is not None for _, v in prolong)
    while t < len(rows) - 1:
        try:
            tail_layout(plans.tail_plan(rows[t:], aggs[t:], prolong[t:], TAIL_BLOCK0_ROWS), elem,
                        valid)
            return t
        except ValueError:
            t += 1
    return t


def tail_params(plan: plans.TailPlan, lay: plans.TailLayout, ops, prolong, r_top, x, xs=None,
                omega=OMEGA, sweeps=COARSEST_SWEEPS, stamps=None) -> TailParams:
    """The kernel's argument: the plan's words and layout, each level's
    (diag, off) and valid, the top's r, the output x, the top's x' scratch
    ``xs`` (a cluster top) and the phase clocks ``stamps`` (or None)."""
    K, C = len(plan.sizes), plan.cluster
    if len(ops) != K or len(prolong) != K - 1:
        raise ValueError(f"a plan of {K} levels takes {K} ops and {K - 1} prolongations")
    if (xs is None) != (C == 0):
        raise ValueError("a cluster top takes an x' scratch vector, a block-0 top none")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    p = TailParams(r_top=r_top.data_ptr(), x_out=x.data_ptr(), xs=ptr(xs),
                   blob=plan.blob.data_ptr(), prog=lay.prog.data_ptr(), stamps=ptr(stamps),
                   omega=float(omega), prog_local=lay.prog_local,
                   prog_stretch=lay.prog_stretch,
                   levels=K, cluster=C, sweeps=int(sweeps), xb=lay.xb, r1=lay.r1, sp=lay.sp,
                   lower=plan.sizes[C - 1] if C else 0)
    for k in range(K):
        lv, lp, (diag, off) = p.lv[k], plan.levels[k], ops[k]
        valid = prolong[k][1] if k < K - 1 else None
        lv.diag, lv.off, lv.valid = diag.data_ptr(), off.data_ptr(), ptr(valid)
        lv.n, lv.stage, lv.cap_rows, lv.cap_terms = lp.n, int(lay.stage[k]), lp.cap_rows, \
            lp.cap_terms
        lv.base, lv.seg, lv.copy = lp.base, lp.seg, lp.copy
        for name in plans.FIELDS[1:-1]:
            setattr(lv, name, lp.at[name])
        lv.st, lv.coef, lv.sdiag = lay.st[k], lay.coef[k], lay.diag[k]
        lv.svalid = lay.valid[k] if valid is not None else -1
        lv.sv, lv.sr, lv.ss = lay.sv[k], lay.sr[k], lay.ss[k]
        lv.lvalid = lay.lvalid[k] if C and prolong[C - 1][1] is not None else -1
        lv.r, lv.v = lay.r[k], lay.v[k]
    return p


_PREPARED: dict = {}


def _prepare(dev, dtype, layout: plans.TailLayout):
    """Allow the opt-in shared memory and the 16-block cluster, and check
    that one such cluster fits on the card, once per device, dtype, threads
    and shared memory; raises with the numbers if none does."""
    smem = layout.smem
    key = (dev.index, dtype, layout.threads, smem)
    if key in _PREPARED:
        return
    clusters = ctypes.c_int(0)
    _raise_on(_entry("amg_tail_prepare", dtype)(layout.threads, smem, ctypes.addressof(clusters)),
              "amg_tail_prepare")
    if clusters.value < 1:
        raise RuntimeError(
            f"amg_tail_kernel: no cluster of {TAIL_BLOCKS} blocks x {layout.threads} threads "
            f"with {smem} B of shared memory a block fits on {dev} "
            f"(cudaOccupancyMaxActiveClusters = {clusters.value})")
    _PREPARED[key] = clusters.value


def amg_tail(rows, aggs, ops, prolong, r_top, omega=OMEGA, sweeps=COARSEST_SWEEPS,
             stamps=None, block0_rows=TAIL_BLOCK0_ROWS):
    """The tail of a V-cycle: from the top level's residual ``r_top``, each
    level down (``amg_down``'s expressions), the coarsest's ``sweeps``
    damped-Jacobi sweeps, each level back up (``amg_up``'s, with
    ``valid`` on a shard), in one launch of one cluster of ``TAIL_BLOCKS``
    blocks, from the tail plan (``ops/amg_tail.py``, made at the first call
    for these index tensors) with its vectors in the blocks' shared memory
    (raises where they do not fit: :func:`tail_layout`); its levels from
    the first of at most ``block0_rows`` rows run in block 0 alone.
    ``rows[k]`` is level k's row plan, ``aggs[k]`` its restriction's (k < K
    - 1), ``ops[k]`` its (diag, off), ``prolong[k]`` the prolongation's
    (index, valid or None), the coarsest last.  ``stamps`` (a CUDA int64
    tensor of ``len(amg_tail.phases(plan)) + 2`` values) adds each phase's
    clocks in block 0, then the launch's ns and clocks.  Returns the top
    level's x."""
    K = len(rows)
    if not 1 <= K <= MAX_TAIL_LEVELS:
        raise ValueError(f"a tail has 1 to {MAX_TAIL_LEVELS} levels, got {K}")
    if len(ops) != K or len(aggs) != K - 1 or len(prolong) != K - 1:
        raise ValueError(f"a tail of {K} levels takes {K} ops and {K - 1} restrictions and "
                         f"prolongations, got {len(ops)}, {len(aggs)}, {len(prolong)}")
    dev = _device(rows[0], r_top, *rows[1:], *aggs)
    _check_vec("r_top", r_top, rows[0].n, r_top)
    for k in range(K):
        n = rows[k].n
        _check_vec(f"diag of level {k}", ops[k][0], n, r_top)
        _check_vec(f"off of level {k}", ops[k][1], rows[k].n_src, r_top)
        if k == K - 1:
            continue
        if aggs[k].n_src != n or aggs[k].n != rows[k + 1].n:
            raise ValueError(f"the restriction of level {k} maps {aggs[k].n_src} rows onto "
                             f"{aggs[k].n}, not {n} onto {rows[k + 1].n}")
        agg, valid = prolong[k]
        if not (torch.is_tensor(agg) and agg.dim() == 1 and agg.shape[0] == n
                and agg.device == dev and agg.dtype in (torch.int32, torch.int64)):
            raise ValueError(f"the prolongation index of level {k} must be an int32 or int64 "
                             f"[{n}] tensor on {dev}")
        if valid is not None:
            _check_vec(f"valid of level {k}", valid, n, r_top)
    if dev.type == "cpu":
        return tail_plain(rows, aggs, ops, prolong, r_top, omega, sweeps)
    x = torch.empty_like(r_top)
    if rows[0].n:
        plan = plans.tail_plan(rows, aggs, prolong, block0_rows)
        lay = tail_layout(plan, r_top.element_size(), any(v is not None for _, v in prolong))
        if stamps is not None and not (stamps.dtype == torch.int64 and stamps.device == dev
                                       and stamps.shape == (len(plans.phases(plan)) + 2,)):
            raise ValueError("stamps must be an int64 tensor of the phases and two on the device")
        xs = torch.empty_like(r_top) if plan.cluster else None
        params = tail_params(plan, lay, ops, prolong, r_top, x, xs, omega, sweeps, stamps)
        _on(dev, lambda: _prepare(dev, r_top.dtype, lay))
        _launch(dev, "amg_tail", r_top.dtype, ctypes.addressof(params), lay.threads, lay.smem)
        amg_tail.launches += 1
    return x


amg_tail.launches = 0


WRAPPERS = (fv_matvec, amg_down, amg_up, amg_tail)
