"""Row plans and plain versions of the AMG-CG pressure solve's kernels.

The JAX package leaves the AMG-preconditioned CG to XLA, which fuses the
matvec (``cudaparticlesfoam_tpu/models/fv.py:420-431``) and each level of
the V-cycle (``:544-570``) inside one ``lax.while_loop``.  The port's
kernels (``csrc/amg.cu``, wrappers in :mod:`.amg_cuda`) do that work in
2t + 2 launches a CG iteration, t the levels above the tail
(:func:`tail_start`); this module holds what they read and the plain
PyTorch version of each:

* :func:`matvec_plain` (``fv_matvec_kernel``): ``diag*x + sum_row coef*x[other]``;
* :func:`down_plain` (``amg_down_kernel``): pre-smooth, residual and
  restriction of one level;
* :func:`up_plain` (``amg_up_kernel``): prolongation and post-smooth;
* :func:`coarsest_plain`: the coarsest level's damped-Jacobi sweeps;
* :func:`tail_plain` (``amg_tail_kernel``): the small levels down, the
  coarsest and the small levels back up, composed of the three above.

A sum into rows follows a :class:`RowPlan`: for each row the terms in the
order of the concatenated index parts, stably sorted by row (so in part
order within a row), summed from 0 left to right, and only then added to
``diag*x``; the plain versions fold the same terms in the same order, so a
kernel equals its plain version bit for bit, and both equal
``fv.index_sum``'s fixed-order path on the CPU.  Plans are made on the host
once per set of index tensors (:func:`sum_plan`, :func:`row_plan`,
:func:`agg_plan`), found again by storage, length and version while the
tensors live, and never made while a CUDA graph is being captured.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

OMEGA = 0.65             # the V-cycle's Jacobi damping (JAX's amg_vcycle)
COARSEST_SWEEPS = 12     # damped-Jacobi sweeps on the coarsest level
MAX_TAIL_LEVELS = 16     # levels one tail launch takes (csrc/amg.cu TAIL_MAX_LEVELS)

_PLANS: dict = {}


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _cached(kind, n_out: int, idxs, build):
    """The plan ``build(n_out, host arrays)`` of index tensors ``idxs``,
    made once and found again while they (or the tensors they view) live;
    the plans of dead tensors go when a new plan is made."""
    dev = idxs[0].device
    key = (kind, n_out, str(dev),
           tuple((i.data_ptr(), i.shape[0], i.stride(0), i._version) for i in idxs))
    hit = _PLANS.get(key)
    if hit is not None and all(r() is not None for r in hit[0]):
        return hit[1]
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"no {kind} plan for these indices while a CUDA graph is being "
                           "captured: run the body once eagerly first")
    for k in [k for k, (refs, _) in _PLANS.items() if any(r() is None for r in refs)]:
        del _PLANS[k]
    plan = build(n_out, [host(i).reshape(-1).astype(np.int64) for i in idxs], dev)
    _PLANS[key] = (tuple(weakref.ref(i if i._base is None else i._base) for i in idxs), plan)
    return plan


def _order(n_out: int, tgts):
    """(order, offsets): the positions in the concatenated parts sorted by
    their index (stable, so in part order within a row), an index outside
    [0, n_out) left out; row i's positions are order[offsets[i]:offsets[i+1]]."""
    tgt = np.concatenate(tgts)
    pos = np.flatnonzero((tgt >= 0) & (tgt < n_out))
    order = pos[np.argsort(tgt[pos], kind="stable")]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(tgt[pos], minlength=n_out))])
    return order, offsets


def sum_plan(n_out: int, idxs):
    """``fv.index_sum``'s (order, offsets), int64 tensors on the indices' device."""
    def build(n, tgts, dev):
        return tuple(torch.as_tensor(x, dtype=torch.int64, device=dev) for x in _order(n, tgts))
    return _cached("sum", n_out, idxs, build)


def int32_index(idx):
    """An int32 copy of an int64 index tensor (the kernels' index width),
    made once per tensor and found again as the plans are."""
    if idx.dtype == torch.int32:
        return idx
    return _cached("int32", idx.shape[0], [idx],
                   lambda n, tgts, dev: torch.as_tensor(tgts[0], dtype=torch.int32, device=dev))


@dataclasses.dataclass(eq=False)
class RowPlan:
    """One sum into ``n`` rows, as CSR on the indices' device: row i's terms
    are ``offsets[i]:offsets[i+1]`` of ``pos`` (the term's position in the
    concatenated parts: face p of part 0 below ``n_src``, face p - n_src of
    part 1 above) and ``col`` (the row the term reads: a matvec's other
    cell, a restriction's fine cell)."""

    n: int
    n_src: int
    offsets: torch.Tensor    # int32 [n + 1]
    pos: torch.Tensor        # int32 [nnz]
    col: torch.Tensor        # int32 [nnz]
    h_offsets: np.ndarray
    h_pos: np.ndarray
    h_col: np.ndarray
    _columns: tuple | None = None

    @property
    def max_len(self) -> int:
        return int(np.diff(self.h_offsets).max(initial=0))

    def columns(self):
        """(inv, [(pos_j, col_j), ...]) for the plain fold: rows sorted by
        length, longest first, so that term j of every row that has one is
        ``pos_j``/``col_j`` over the first len(pos_j) sorted rows; ``inv``
        puts the sorted rows back in order.  Made at first use."""
        if self._columns is None:
            lens = np.diff(self.h_offsets)
            perm = np.argsort(-lens, kind="stable")
            dev = self.offsets.device
            as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)  # noqa: E731
            cols = []
            for j in range(self.max_len):
                idx = self.h_offsets[perm[: int((lens > j).sum())]] + j
                cols.append((as_t(self.h_pos[idx]), as_t(self.h_col[idx])))
            self._columns = (as_t(np.argsort(perm, kind="stable")), cols)
        return self._columns


def _row_plan(n: int, n_src: int, order, offsets, col, dev) -> RowPlan:
    as_i = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    if order.size and max(order.max(), col.max()) >= 2 ** 31:
        raise ValueError("a row plan indexes at most 2^31 terms")
    return RowPlan(n=n, n_src=n_src, offsets=as_i(offsets), pos=as_i(order), col=as_i(col),
                   h_offsets=offsets, h_pos=order, h_col=col)


def row_plan(n_out: int, own, nei) -> RowPlan:
    """The rows of a matvec over the faces (own, nei): a face adds
    ``upper * x[nei]`` to row own and ``lower * x[own]`` to row nei, in
    ``fv.index_sum``'s order.  A face whose two cells are one adds nothing:
    no mesh face joins a cell to itself, but a shard mesh pads its face
    tables with such faces (zero geometry, so zero coefficients), tens of
    thousands of them on one dummy cell at full width, and a row that long
    would hold one thread for milliseconds."""
    def build(n, tgts, dev):
        o, ne = tgts
        loop = o == ne
        order, offsets = _order(n, [np.where(loop, -1, o), np.where(loop, -1, ne)])
        nf = o.shape[0]
        col = np.where(order < nf, ne[np.minimum(order, nf - 1)], o[order - nf])
        return _row_plan(n, nf, order, offsets, col, dev)
    return _cached("rows", n_out, [own, nei], build)


def agg_plan(n_out: int, agg) -> RowPlan:
    """The rows of a restriction: coarse row c sums the fine rows i with
    ``agg[i] == c`` in fine order; an index outside [0, n_out) is dropped."""
    def build(n, tgts, dev):
        order, offsets = _order(n, tgts)
        return _row_plan(n, tgts[0].shape[0], order, offsets, order, dev)
    return _cached("aggs", n_out, [agg], build)


def _fold(plan: RowPlan, term, like):
    """sum_row term(pos_j, col_j) from 0, left to right, for each of the
    plan's rows: [plan.n] + like's trailing shape, in like's dtype."""
    inv, cols = plan.columns()
    acc = like.new_zeros((plan.n,) + tuple(like.shape[1:]))
    for pj, cj in cols:
        nj = pj.shape[0]
        acc[:nj] = acc[:nj] + term(pj, cj)
    return acc[inv]


def matvec_plain(plan: RowPlan, diag, upper, lower, x):
    """``fv_matvec_kernel``'s plain version: ``diag*x + sum_row coef*x[col]``,
    x [n] or [n, k]."""
    coef = torch.cat([upper, lower])
    if x.ndim == 2:
        acc = _fold(plan, lambda p, c: coef[p][:, None] * x[c], x)
        return diag[:, None] * x + acc
    return diag * x + _fold(plan, lambda p, c: coef[p] * x[c], x)


def down_plain(rows: RowPlan, aggs: RowPlan, diag, off, r, omega=OMEGA):
    """``amg_down_kernel``'s plain version: x = omega r / d, r1 = r - A x,
    and the coarse residual ``rc[c] = sum_{i in agg c} r1[i]``."""
    x = omega * r / diag
    r1 = r - matvec_plain(rows, diag, off, off, x)
    return _fold(aggs, lambda p, c: r1[c], r1)


def up_plain(rows: RowPlan, diag, off, r, agg, xc, valid=None, omega=OMEGA):
    """``amg_up_kernel``'s plain version: x' = omega r / d + xc[agg] (times
    ``valid`` on a shard), then x' + omega (r - A x') / d."""
    x = omega * r / diag
    x = x + (xc[agg] if valid is None else xc[agg] * valid)
    return x + omega * (r - matvec_plain(rows, diag, off, off, x)) / diag


def coarsest_plain(rows: RowPlan, diag, off, r, omega=OMEGA, sweeps=COARSEST_SWEEPS):
    """The coarsest level (the tail's middle phase): x = omega r / d, then
    ``sweeps`` damped-Jacobi sweeps."""
    x = omega * r / diag
    for _ in range(sweeps):
        x = x + omega * (r - matvec_plain(rows, diag, off, off, x)) / diag
    return x


def tail_start(sizes, tail_rows: int) -> int:
    """The first level of the tail of a hierarchy whose levels have
    ``sizes`` rows (level 0 first, the coarsest last): the first level from
    which every level has at most ``tail_rows`` rows, but never past the
    coarsest, which is always in the tail, nor more than
    ``MAX_TAIL_LEVELS`` levels from it."""
    last = len(sizes) - 1
    if last < 0:
        raise ValueError("a hierarchy has at least one level")
    t = last
    while t > 0 and sizes[t - 1] <= tail_rows:
        t -= 1
    return max(t, last + 1 - MAX_TAIL_LEVELS)


def tail_plain(rows, aggs, ops, prolong, r_top, omega=OMEGA, sweeps=COARSEST_SWEEPS):
    """``amg_tail_kernel``'s plain version on the K levels of a tail:
    ``rows[k]`` level k's row plan, ``aggs[k]`` its restriction's (k < K -
    1), ``ops[k]`` its (diag, off), ``prolong[k]`` the prolongation's
    (index, valid or None); :func:`down_plain` from ``r_top`` to the
    coarsest, :func:`coarsest_plain`, :func:`up_plain` back.  Returns the
    top level's x."""
    rs = [r_top]
    for k, ag in enumerate(aggs):
        rs.append(down_plain(rows[k], ag, *ops[k], rs[k], omega))
    x = coarsest_plain(rows[-1], *ops[-1], rs[-1], omega, sweeps)
    for k in reversed(range(len(aggs))):
        agg, valid = prolong[k]
        x = up_plain(rows[k], *ops[k], rs[k], agg, x, valid, omega)
    return x
