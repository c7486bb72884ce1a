"""The tail plan of ``amg_tail_kernel`` (``csrc/amg.cu``): where each row of
each tail level lives in the kernel's cluster of 16 blocks, and the index
data every phase reads, made once per hierarchy on the host.

A tail of K levels (level 0 its top, K - 1 the coarsest) splits in two.
The **cluster levels** 0 .. C - 1 are spread over the 16 blocks; the
**block-0 levels** C .. K - 1 (every level from the first one of at most
``block0_rows`` rows down, and always the coarsest) run in block 0 alone,
their phases behind ``__syncthreads``.  Level P = C - 1 is split into 16
contiguous ranges of about equal weight (the rows that descend to them);
every finer row lives in the block that owns its aggregate (``prolong``'s
index), so a restriction sums only its own block's rows and a
prolongation writes only into them.  Within a block the rows take slots in
index order.

For each level and block the plan holds one **segment** of int32 words,
``seg`` words a block from ``base``, the same offsets in every block:

* ``hdr``: the block's rows, terms, restriction members, prolongation members;
* ``toff`` [rows + 1], ``addr`` [terms]: each own row's terms in the row
  plan's order and each term's neighbour: on the top level (cluster) its
  index, on the other cluster levels the packed address ``rank << 16 |
  slot`` of its owner's shared memory, on a block-0 level its index;
* ``moff``, ``mem``: the restriction's members of each own row on the
  level above (``agg_plan``'s order), ``poff``, ``pmem``: the
  prolongation's; as slots of this block where both levels are cluster
  levels, else (level C and the block-0 levels) as indices;
* ``grow`` [rows]: each own row's index;
* ``ldst`` [n_P] (level C only): where each row of level P lives, packed;
* ``tslot`` [terms] (the cluster top only): each term's neighbour among the
  block's distinct neighbours ``nbr`` (its own rows first, in slot order,
  then the other rows its terms read), whose r and diag the prologue
  gathers once each; the top's ``hdr`` counts them in place of members;
* then, read only by the prologue's gathers: ``cpos`` [terms], each term's
  position in the level's ``off`` (the row plan's ``pos`` already folded
  into [0, nf)), and ``nbr``.

The first ``copy`` words of a segment are what the phases read; the
kernel copies them into shared memory (``cp.async.bulk``) where the level
is staged, and its prologue runs the gather programs of :func:`programs`
(made with the shared-memory :func:`layout`) for the values they index.
The plan holds no value: the matrix changes every solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .amg import MAX_TAIL_LEVELS, _cached, int32_index

TAIL_BLOCKS = 16          # csrc/amg.cu TAIL_BLOCKS
SLOT_BITS = 16            # a packed address: rank << SLOT_BITS | slot
HDR_WORDS = 4
# the words of a level's segment, in order; those after "ldst" are not copied
FIELDS = ("hdr", "toff", "addr", "moff", "mem", "poff", "pmem", "grow", "ldst", "tslot", "cpos",
          "nbr")
COPIED = FIELDS[: FIELDS.index("tslot") + 1]


def _pad4(n: int) -> int:
    return (int(n) + 3) & ~3


def cluster_levels(sizes, block0_rows: int) -> int:
    """C: the levels of a tail with ``sizes`` rows from which on (to the
    coarsest) every level has at most ``block0_rows`` rows run in block 0;
    the C above them are spread over the cluster."""
    K = len(sizes)
    C = K - 1
    while C > 0 and sizes[C - 1] <= block0_rows:
        C -= 1
    return C


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One level's segment layout (words), the same in each of its ``nseg``
    blocks (16 on a cluster level, 1 on a block-0 level)."""
    n: int
    nseg: int
    cap_rows: int
    cap_terms: int
    base: int
    seg: int
    copy: int
    at: dict          # field -> word offset in a segment
    lower: int        # rows of level P a level-C segment addresses (ldst), else 0
    cap_nbrs: int     # distinct neighbours of a block's rows on the cluster top, else 0


@dataclasses.dataclass(eq=False)
class TailPlan:
    """A tail's plan: ``sizes``, ``cluster`` (C), per level the owner block
    and slot of every row (``owner``, ``slot``; the block-0 levels: 0 and
    the index) and its :class:`LevelPlan`, the host words ``h_blob`` and
    the same words on the device (``blob``), and ``remote_terms``: the
    terms of cluster levels 1 .. C - 1 whose neighbour lives in another
    block, out of ``cluster_terms``."""
    sizes: tuple
    cluster: int
    block0_rows: int
    owner: tuple
    slot: tuple
    levels: tuple
    h_blob: np.ndarray
    blob: torch.Tensor
    remote_terms: int
    cluster_terms: int
    _layouts: dict = dataclasses.field(default_factory=dict)


def _owners(sizes, C, parent):
    """(owner, slot) of every row of every level: level P in contiguous
    ranges of about equal weight (itself and the rows of the cluster
    levels that descend to it), finer rows with their aggregate."""
    K = len(sizes)
    owner = [np.zeros(n, np.int64) for n in sizes]
    if C >= 1:
        P = C - 1
        w = np.ones(sizes[0], np.int64)
        for k in range(P):
            w = 1 + np.bincount(parent[k], weights=w, minlength=sizes[k + 1]).astype(np.int64)
        start = np.cumsum(w) - w
        owner[P] = np.minimum(start * TAIL_BLOCKS // max(int(w.sum()), 1), TAIL_BLOCKS - 1)
        for k in range(P - 1, -1, -1):
            owner[k] = owner[k + 1][parent[k]]
    slot = []
    for k in range(K):
        s = np.zeros(sizes[k], np.int64)
        for b in range(TAIL_BLOCKS if k < C else 1):
            mine = np.flatnonzero(owner[k] == b)
            s[mine] = np.arange(mine.size)
        slot.append(s)
    return owner, slot


def _ranges(starts, ends):
    """The concatenated ranges [starts[i], ends[i]) and their offsets."""
    lens = ends - starts
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.repeat(starts - off[:-1], lens) + np.arange(off[-1])
    return idx, off


def _members(offsets, rows):
    """Positions of the members of coarse ``rows`` (offsets into a member
    list) and the offsets of each row's run."""
    return _ranges(offsets[rows], offsets[rows + 1])


def build(sizes, h_rows, h_aggs, parent, block0_rows, dev) -> TailPlan:
    """The plan from host arrays: ``h_rows[k]`` = (offsets, pos, col, nf) of
    level k's row plan, ``h_aggs[k]`` = (offsets, col) of its restriction
    onto k + 1, ``parent[k]`` the prolongation's index of level k."""
    K = len(sizes)
    if not 1 <= K <= MAX_TAIL_LEVELS:
        raise ValueError(f"a tail has 1 to {MAX_TAIL_LEVELS} levels, got {K}")
    for k in range(K - 1):
        if parent[k].shape != (sizes[k],) or (parent[k].size and (
                parent[k].min() < 0 or parent[k].max() >= sizes[k + 1])):
            raise ValueError(f"the prolongation index of level {k} must map its {sizes[k]} "
                             f"rows into [0, {sizes[k + 1]})")
        ao, ac = h_aggs[k]
        kids = np.repeat(np.arange(sizes[k + 1]), np.diff(ao))
        if np.any(parent[k][ac] != kids):
            raise ValueError(f"level {k}: a row's restriction and prolongation indices differ "
                             "(the tail keeps a row with its aggregate)")
    C = cluster_levels(sizes, block0_rows)
    owner, slot = _owners(sizes, C, parent)
    for k in range(C):
        if np.bincount(owner[k], minlength=TAIL_BLOCKS).max(initial=0) >= 1 << SLOT_BITS:
            raise ValueError(f"level {k}: more than {(1 << SLOT_BITS) - 1} rows in a block")
    # prolongation members of each coarse row, in fine order
    pkids = []
    for k in range(K - 1):
        order = np.argsort(parent[k], kind="stable")
        counts = np.bincount(parent[k], minlength=sizes[k + 1])
        pkids.append((np.concatenate([[0], np.cumsum(counts)]), order))
    P = C - 1
    segs, remote, cterms = [], 0, 0
    for k in range(K):
        offs, pos, col, nf = h_rows[k]
        nb = TAIL_BLOCKS if k < C else 1
        blocks = []
        for b in range(nb):
            grow = np.flatnonzero(owner[k] == b) if k < C else np.arange(sizes[k])
            tidx, toff = _ranges(offs[grow], offs[grow + 1])
            cols, p = col[tidx], pos[tidx]
            cpos = np.where(p < nf, p, p - nf)
            if k < C and k > 0:
                addr = owner[k][cols] << SLOT_BITS | slot[k][cols]
                remote += int((owner[k][cols] != b).sum())
                cterms += cols.size
            else:
                addr = cols
            none = np.zeros(0, np.int64)
            f = dict(hdr=None, toff=toff, addr=addr, grow=grow, cpos=cpos, moff=none,
                     mem=none, poff=none, pmem=none, ldst=none, tslot=none, nbr=none)
            if k == 0 and C >= 1:     # the top's distinct neighbours, own rows first
                nbr = np.concatenate([grow, np.setdiff1d(cols, grow)])
                order = np.argsort(nbr, kind="stable")
                f.update(nbr=nbr, tslot=order[np.searchsorted(nbr[order], cols)])
            if k >= 1:
                ao, ac = h_aggs[k - 1]
                midx, moff = _members(ao, grow)
                pidx, poff = _members(pkids[k - 1][0], grow)
                mem, pmem = ac[midx], pkids[k - 1][1][pidx]
                if k < C:       # both cluster levels: this block's slots
                    mem, pmem = slot[k - 1][mem], slot[k - 1][pmem]
                f.update(moff=moff, mem=mem, poff=poff, pmem=pmem)
                if k == C:
                    f["ldst"] = owner[P] << SLOT_BITS | slot[P]
            f["hdr"] = np.array([grow.size, tidx.size, f["mem"].size or f["nbr"].size,
                                 f["pmem"].size])
            blocks.append(f)
        segs.append(blocks)
    levels, base, words = [], 0, []
    for k, blocks in enumerate(segs):
        cap_rows = max(f["grow"].size for f in blocks)
        cap_terms = max(f["addr"].size for f in blocks)
        cap = dict(hdr=HDR_WORDS, toff=cap_rows + 1, addr=cap_terms,
                   moff=cap_rows + 1 if k else 0, mem=max(f["mem"].size for f in blocks),
                   poff=cap_rows + 1 if k else 0, pmem=max(f["pmem"].size for f in blocks),
                   grow=cap_rows, ldst=max(f["ldst"].size for f in blocks),
                   tslot=max(f["tslot"].size for f in blocks), cpos=cap_terms,
                   nbr=max(f["nbr"].size for f in blocks))
        at, w = {}, 0
        for name in FIELDS:
            at[name] = w
            w += _pad4(cap[name])
            if name == COPIED[-1]:
                copy = w
        seg = np.zeros((len(blocks), w), np.int64)
        for b, f in enumerate(blocks):
            for name in FIELDS:
                seg[b, at[name]: at[name] + f[name].size] = f[name]
        levels.append(LevelPlan(n=sizes[k], nseg=len(blocks), cap_rows=cap_rows,
                                cap_terms=cap_terms, base=base, seg=w, copy=copy, at=at,
                                lower=cap["ldst"], cap_nbrs=cap["nbr"]))
        words.append(seg.reshape(-1))
        base += seg.size
    h_blob = np.concatenate(words) if words else np.zeros(0, np.int64)
    if h_blob.size and (h_blob.max() >= 2 ** 31 or h_blob.min() < 0):
        raise ValueError("a tail plan holds int32 words")
    h_blob = h_blob.astype(np.int32)
    return TailPlan(sizes=tuple(int(n) for n in sizes), cluster=C, block0_rows=block0_rows,
                    owner=tuple(o.astype(np.int32) for o in owner),
                    slot=tuple(s.astype(np.int32) for s in slot), levels=tuple(levels),
                    h_blob=h_blob, blob=torch.as_tensor(h_blob, device=dev),
                    remote_terms=remote, cluster_terms=cterms)


def tail_plan(rows, aggs, prolong, block0_rows: int) -> TailPlan:
    """The plan of a tail (``amg_tail``'s row plans, restriction plans and
    prolongation indices), made once per set of index tensors and found
    again as the row plans are (``ops/amg._cached``: never made while a
    CUDA graph is being captured)."""
    K = len(rows)
    if not 1 <= K <= MAX_TAIL_LEVELS:
        raise ValueError(f"a tail has 1 to {MAX_TAIL_LEVELS} levels, got {K}")
    parents = [int32_index(a) for a, _ in prolong]
    idxs = [p.offsets for p in rows] + [a.offsets for a in aggs] + parents

    def make(_n, host, dev):
        return build([p.n for p in rows],
                     [(p.h_offsets, p.h_pos, p.h_col, p.n_src) for p in rows],
                     [(a.h_offsets, a.h_col) for a in aggs], host[2 * K - 1:], block0_rows, dev)

    return _cached(("tail", block0_rows), rows[0].n, idxs, make)


@dataclasses.dataclass(frozen=True)
class TailLayout:
    """Where a tail keeps what it reads in a block's shared memory (bytes,
    the same offsets in every block).  ``r`` / ``v`` per level: the level's
    r and v (s = omega r / d, then x') of the block's rows (-1 on the top
    cluster level, whose r is the caller's and v a global scratch vector);
    ``xb`` the coarsest's second sweep buffer; ``r1`` / ``sp`` level P's r1
    and s in block 0; ``stage`` per level whether its segment and values
    are staged, at ``st`` (the copied words), ``coef``, ``diag``, ``valid``,
    ``sr`` / ``sv`` (= ``ss``) the cluster top's distinct neighbours' r and
    s (its own rows first; ``diag`` theirs too) and ``lvalid`` (level P's
    valid, on level C); ``vectors`` the bytes that must fit, ``full`` those
    with every level staged, ``smem`` those used, ``threads``; ``prog`` the
    prologue's gather program (:func:`programs`): ``prog_local`` items a
    block, then ``prog_stretch`` for block 0's levels."""
    elem: int
    r: tuple
    v: tuple
    xb: int
    r1: int
    sp: int
    stage: tuple
    st: tuple
    coef: tuple
    diag: tuple
    valid: tuple
    sv: tuple
    sr: tuple
    ss: tuple
    lvalid: tuple
    vectors: int
    full: int
    smem: int
    threads: int
    prog: torch.Tensor = None
    prog_local: int = 0
    prog_stretch: int = 0


def _align(n: int) -> int:
    return (int(n) + 15) & ~15


def layout(plan: TailPlan, elem: int, valid: bool, budget: int, max_threads: int) -> TailLayout:
    """The shared-memory layout of ``plan`` with ``elem``-byte values and,
    with ``valid``, the prolongation's valid: first every level's vectors
    (raises, with the numbers, where they do not fit in ``budget`` bytes),
    then the levels' staged segments and values, from the coarsest up
    while they fit."""
    key = (elem, valid, budget, max_threads)
    if key in plan._layouts:
        return plan._layouts[key]
    K, C = len(plan.sizes), plan.cluster
    at = 0
    r, v = [-1] * K, [-1] * K
    for k in range(K):
        if k == 0 and C >= 1:
            continue
        n = plan.levels[k].cap_rows
        r[k], v[k] = at, at + _align(n * elem)
        at = v[k] + _align(n * elem)
    xb = at
    at += _align(plan.sizes[-1] * elem)
    r1 = sp = -1
    if C >= 1:
        nP = plan.sizes[C - 1]
        r1, sp = at, at + _align(nP * elem)
        at = sp + _align(nP * elem)
    vectors = at
    if vectors > budget:
        raise ValueError(
            f"the tail of levels {list(plan.sizes)} keeps {vectors} B of vectors in a block's "
            f"shared memory ({elem} B values, levels 0..{C - 1} over {TAIL_BLOCKS} blocks), "
            f"more than its {budget} B")

    def staged_bytes(k):
        lp = plan.levels[k]
        top = k == 0 and C >= 1   # diag, r and s of its distinct neighbours
        b = _align(4 * lp.copy) + _align(lp.cap_terms * elem)
        b += 3 * _align(lp.cap_nbrs * elem) if top else _align(lp.cap_rows * elem)
        if valid and k < K - 1:
            b += _align(lp.cap_rows * elem)
        if k == C and C >= 1 and valid:
            b += _align(lp.lower * elem)
        return b

    stage = [False] * K
    total = vectors
    for k in list(range(K - 1, C - 1, -1)) + list(range(C - 1, -1, -1)):
        if total + staged_bytes(k) > budget:
            break
        stage[k] = True
        total += staged_bytes(k)
    st, coef, dg, vd, sv, sr, ss, lv = ([-1] * K for _ in range(8))
    for k in range(K):
        if not stage[k]:
            continue
        lp = plan.levels[k]
        st[k] = at
        at += _align(4 * lp.copy)
        coef[k] = at
        at += _align(lp.cap_terms * elem)
        dg[k] = at                # the top: its distinct neighbours' diag, own rows first
        at += _align((lp.cap_nbrs if k == 0 and C >= 1 else lp.cap_rows) * elem)
        if valid and k < K - 1:
            vd[k] = at
            at += _align(lp.cap_rows * elem)
        if k == 0 and C >= 1:     # and their r and s (sv and ss: one array)
            sr[k] = at
            sv[k] = ss[k] = at + _align(lp.cap_nbrs * elem)
            at = sv[k] + _align(lp.cap_nbrs * elem)
        if k == C and C >= 1 and valid:
            lv[k] = at
            at += _align(lp.lower * elem)
    assert at == total
    rows = max([plan.levels[k].cap_rows for k in range(K)] + [1])
    threads = min(max_threads, max(32, -(-rows // 32) * 32))
    out = TailLayout(elem=elem, r=tuple(r), v=tuple(v), xb=xb, r1=r1, sp=sp, stage=tuple(stage),
                     st=tuple(st), coef=tuple(coef), diag=tuple(dg), valid=tuple(vd),
                     sv=tuple(sv), sr=tuple(sr), ss=tuple(ss), lvalid=tuple(lv),
                     vectors=vectors, full=vectors + sum(map(staged_bytes, range(K))),
                     smem=at, threads=threads)
    local, stretch = programs(plan, out)
    nloc = max((x.shape[0] for x in local), default=0)
    words = [np.concatenate([x, np.tile([NO_SOURCE << IDX_BITS, 0], (nloc - x.shape[0], 1))])
             for x in local] + [stretch]
    h = np.concatenate([w.reshape(-1) for w in words]).astype(np.int32)
    out = dataclasses.replace(out, prog=torch.as_tensor(h, device=plan.blob.device),
                              prog_local=nloc, prog_stretch=stretch.shape[0])
    plan._layouts[key] = out
    return out


# a gather program's item: source << IDX_BITS | index, then the element of
# shared memory it fills; source 3 k + 0 / 1 / 2 is level k's off / diag /
# valid, SRC_RTOP the top's r, NO_SOURCE a pad
IDX_BITS = 26
SRC_RTOP = 3 * MAX_TAIL_LEVELS
NO_SOURCE = 63


def _items(src, idx, dst):
    idx = np.asarray(idx, np.int64)
    if idx.size and idx.max() >= 1 << IDX_BITS:
        raise ValueError(f"a gather index must be below 2^{IDX_BITS}")
    return np.stack([np.full(idx.shape, src, np.int64) << IDX_BITS | idx,
                     np.asarray(dst, np.int64) + np.zeros(idx.shape, np.int64)], axis=1)


def programs(plan: TailPlan, lay: TailLayout):
    """The prologue's gather programs for ``lay``: (one [n, 2] item array a
    block: the staged values of its cluster levels, raw; the top's s are
    computed from its neighbours' r and diag after), and ([n, 2]) block 0's
    levels', which the cluster gathers for it (C = 0: block 0 alone)."""
    K, C, e = len(plan.sizes), plan.cluster, lay.elem

    def seg(k, b):
        lp = plan.levels[k]
        w = plan.h_blob[lp.base + b * lp.seg: lp.base + (b + 1) * lp.seg].astype(np.int64)
        rows, terms, at = int(w[0]), int(w[1]), lp.at
        nbrs = int(w[2]) if k == 0 and C >= 1 else 0
        return (w[at["cpos"]: at["cpos"] + terms], w[at["grow"]: at["grow"] + rows],
                w[at["nbr"]: at["nbr"] + nbrs])

    def level_items(k, b):
        cpos, grow, nbr = seg(k, b)
        rows = nbr if k == 0 and C >= 1 else grow     # the top: every distinct neighbour
        out = [_items(3 * k, cpos, lay.coef[k] // e + np.arange(cpos.size)),
               _items(3 * k + 1, rows, lay.diag[k] // e + np.arange(rows.size))]
        if lay.valid[k] >= 0:
            out.append(_items(3 * k + 2, grow, lay.valid[k] // e + np.arange(grow.size)))
        if k == 0 and C >= 1:
            out.append(_items(SRC_RTOP, nbr, lay.sr[0] // e + np.arange(nbr.size)))
        if k == C and C >= 1 and lay.lvalid[k] >= 0:
            nP = plan.sizes[C - 1]
            out.append(_items(3 * (C - 1) + 2, np.arange(nP), lay.lvalid[k] // e + np.arange(nP)))
        return out

    empty = np.zeros((0, 2), np.int64)
    local = [np.concatenate([empty] + [x for k in range(C) if lay.stage[k]
                                       for x in level_items(k, b)]) for b in range(TAIL_BLOCKS)]
    stretch = np.concatenate([empty] + [x for k in range(C, K) if lay.stage[k]
                                        for x in level_items(k, 0)])
    return local, stretch


def phases(plan: TailPlan) -> list:
    """The names of the kernel's timed phases in order (``amg_tail(...,
    stamps=)``): the prologue's parts (the block's own gathers, the wait
    for every block to run, block 0's levels' gathers by the cluster, the
    top's s from the gathered values), each cluster level's restriction, level P's
    residual sent to block 0, block 0's levels (each restriction, the
    coarsest, each prolongation), then each cluster level's prolongation
    and smoothing."""
    K, C = len(plan.sizes), plan.cluster
    out = ["prologue: own gathers", "prologue: cluster start", "prologue: block 0's levels",
           "prologue: the top's s"]
    out += [f"down {k}" for k in range(C - 1)]
    if C >= 1:
        out += [f"boundary {C - 1}", f"entry {C}"]
    out += [f"down {k}" for k in range(C, K - 1)]
    out += ["coarsest"]
    out += [f"up {k}" for k in range(K - 2, C - 1, -1)]
    out += [f"up {k}" for k in range(C - 1, -1, -1)]
    return out
