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
  of one cluster of 16 thread blocks; :func:`amg_coarsest` is the tail of the
  coarsest level alone.

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
import dataclasses

import torch

from .amg import (COARSEST_SWEEPS, MAX_TAIL_LEVELS, OMEGA, RowPlan, down_plain, int32_index,
                  matvec_plain, tail_plain, up_plain)
from .fused_cuda import _SUFFIX, _check, _entry, _raise_on, _stream_ptr

# A level of at most TAIL_ROWS rows runs in the tail (ops/amg.py:tail_start);
# 0 leaves the coarsest alone there.  Fixed from the crossover of a level's
# amg_down + amg_up against the tail's two phases at that level
# (chip_smoke.py 14a, PERF.md).
TAIL_ROWS = 8_192
# must match csrc/amg.cu: the tail's cluster of TAIL_BLOCKS blocks of at
# most TAIL_THREADS threads, its vectors in their shared memory
TAIL_BLOCKS = 16
TAIL_THREADS = 512
TAIL_SMEM_BYTES = 230_912       # the opt-in 227 KB less the level table
_ALL_IN_BLOCK_0 = 31


class TailLevel(ctypes.Structure):
    """``csrc/amg.cu:TailLevel``: one level of the tail."""
    _fields_ = [("off", ctypes.c_void_p), ("pos", ctypes.c_void_p), ("col", ctypes.c_void_p),
                ("diag", ctypes.c_void_p), ("offc", ctypes.c_void_p),
                ("aoff", ctypes.c_void_p), ("acell", ctypes.c_void_p),
                ("agg", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("n", ctypes.c_int32), ("nf", ctypes.c_int32), ("shift", ctypes.c_int32),
                ("r_at", ctypes.c_int32), ("x_at", ctypes.c_int32), ("pad", ctypes.c_int32)]


class TailParams(ctypes.Structure):
    """``csrc/amg.cu:TailParams``: the kernel's one argument, passed by
    value (a CUDA graph captures it whole)."""
    _fields_ = [("r_top", ctypes.c_void_p), ("x_out", ctypes.c_void_p),
                ("omega", ctypes.c_double),
                ("levels", ctypes.c_int32), ("sweeps", ctypes.c_int32),
                ("xb_at", ctypes.c_int32), ("stage", ctypes.c_int32),
                ("st_diag", ctypes.c_int32), ("st_coef", ctypes.c_int32),
                ("st_col", ctypes.c_int32), ("st_off", ctypes.c_int32),
                ("lv", TailLevel * MAX_TAIL_LEVELS)]


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


@dataclasses.dataclass(frozen=True)
class TailLayout:
    """Where the tail keeps its vectors in the shared memory of the
    cluster's blocks: level k's rows split over the blocks by ``shifts[k]``
    (row i in block i >> shift; 31 puts the coarsest in block 0), its r and
    x at element ``r_at[k]`` / ``x_at[k]`` of a block's copy (the levels
    below the top; the top's r and x are the caller's), the coarsest's
    second sweep buffer at ``xb_at``, ``elements`` in all.  With ``stage``
    block 0 copies the coarsest's diag, each term's coefficient and column
    and its row offsets into its shared memory at the byte offsets ``st``
    (diag, coef, col, off).  ``smem`` bytes of shared memory a block,
    ``threads`` a block."""
    shifts: tuple
    r_at: tuple
    x_at: tuple
    xb_at: int
    elements: int
    stage: bool
    st: tuple
    smem: int
    threads: int


def tail_layout(sizes, nnz: int, elem: int) -> TailLayout:
    """The layout of a tail of levels with ``sizes`` rows, the coarsest
    last with ``nnz`` terms in its row plan, ``elem`` bytes a value; the
    coarsest is staged where it fits beside the vectors.  Raises, with the
    numbers, where the vectors do not fit in ``TAIL_SMEM_BYTES`` a block."""
    K = len(sizes)
    if not 1 <= K <= MAX_TAIL_LEVELS:
        raise ValueError(f"a tail has 1 to {MAX_TAIL_LEVELS} levels, got {K}")
    # a block's rows: ceil(n / TAIL_BLOCKS) rounded up to a power of two
    shifts = [(max(1, -(-n // TAIL_BLOCKS)) - 1).bit_length() for n in sizes[:-1]]
    shifts.append(_ALL_IN_BLOCK_0)
    at, r_at, x_at = 0, [0] * K, [0] * K
    for k in range(1, K):
        cap = sizes[k] if k == K - 1 else 1 << shifts[k]
        r_at[k], x_at[k] = at, at + cap
        at += 2 * cap
    if K == 1:
        x_at[0] = at
        at += sizes[0]
    xb_at, elements = at, at + sizes[-1]
    base = elements * elem
    if base > TAIL_SMEM_BYTES:
        raise ValueError(
            f"the tail of levels {list(sizes)} keeps {elements} values of {elem} B "
            f"({base} B) in a block's shared memory, more than its {TAIL_SMEM_BYTES} B")
    n = sizes[-1]
    st = (base, base + n * elem, base + (n + nnz) * elem, base + (n + nnz) * elem + 4 * nnz)
    stage = st[3] + 4 * (n + 1) <= TAIL_SMEM_BYTES
    smem = st[3] + 4 * (n + 1) if stage else base
    per_block = [min(1 << sh, rows) for sh, rows in zip(shifts[:-1], sizes[:-1])] + [n]
    threads = min(TAIL_THREADS, max(32, -(-max(per_block) // 32) * 32))
    return TailLayout(tuple(shifts), tuple(r_at), tuple(x_at), xb_at, elements, stage,
                      st if stage else (0, 0, 0, 0), smem, threads)


def tail_params(rows, aggs, ops, prolong, r_top, x, layout: TailLayout, omega=OMEGA,
                sweeps=COARSEST_SWEEPS) -> TailParams:
    """The kernel's argument for a tail of K levels (``amg_tail``'s
    arguments, the output ``x`` and the layout); raises past
    ``MAX_TAIL_LEVELS`` levels."""
    K = len(rows)
    if not 1 <= K <= MAX_TAIL_LEVELS:
        raise ValueError(f"a tail has 1 to {MAX_TAIL_LEVELS} levels, got {K}")
    p = TailParams(r_top=r_top.data_ptr(), x_out=x.data_ptr(), omega=float(omega), levels=K,
                   sweeps=int(sweeps), xb_at=layout.xb_at, stage=int(layout.stage))
    p.st_diag, p.st_coef, p.st_col, p.st_off = layout.st
    for k in range(K):
        lv, (diag, off) = p.lv[k], ops[k]
        lv.off, lv.pos, lv.col, lv.nf = _plan_args(rows[k])
        lv.diag, lv.offc, lv.n = diag.data_ptr(), off.data_ptr(), rows[k].n
        lv.shift, lv.r_at, lv.x_at = layout.shifts[k], layout.r_at[k], layout.x_at[k]
        if k < K - 1:
            agg, valid = prolong[k]
            lv.aoff, lv.acell = aggs[k].offsets.data_ptr(), aggs[k].col.data_ptr()
            lv.agg = int32_index(agg).data_ptr()
            lv.valid = None if valid is None else valid.data_ptr()
    return p


_PREPARED: dict = {}


def _prepare(dev, dtype, layout: TailLayout):
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


def amg_tail(rows, aggs, ops, prolong, r_top, omega=OMEGA, sweeps=COARSEST_SWEEPS):
    """The tail of a V-cycle: from the top level's residual ``r_top``, each
    level down (``amg_down``'s expressions), the coarsest's ``sweeps``
    damped-Jacobi sweeps, each level back up (``amg_up``'s, with
    ``valid`` on a shard), in one launch of one cluster of ``TAIL_BLOCKS``
    blocks, each level's r and x in the blocks' shared memory (raises where
    they do not fit: :func:`tail_layout`).
    ``rows[k]`` is level k's row plan, ``aggs[k]`` its restriction's (k < K
    - 1), ``ops[k]`` its (diag, off), ``prolong[k]`` the prolongation's
    (index, valid or None), the coarsest last.  Returns the top level's x."""
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
        layout = tail_layout([p.n for p in rows], int(rows[-1].h_offsets[-1]),
                             r_top.element_size())
        params = tail_params(rows, aggs, ops, prolong, r_top, x, layout, omega, sweeps)
        _on(dev, lambda: _prepare(dev, r_top.dtype, layout))
        _launch(dev, "amg_tail", r_top.dtype, ctypes.addressof(params), layout.threads,
                layout.smem)
        amg_tail.launches += 1
    return x


amg_tail.launches = 0


def amg_coarsest(rows: RowPlan, diag, off, r, omega=OMEGA, sweeps=COARSEST_SWEEPS):
    """The coarsest level alone: x = omega r / d, then ``sweeps``
    damped-Jacobi sweeps; the tail of one level (one ``amg_tail`` launch).
    Returns x [n]."""
    return amg_tail([rows], [], [(diag, off)], [], r, omega, sweeps)


WRAPPERS = (fv_matvec, amg_down, amg_up, amg_tail)

