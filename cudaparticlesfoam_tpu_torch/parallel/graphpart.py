"""Multilevel graph partitioner for decomposePar scotch/metis parity (port of
``cudaparticlesfoam_tpu/parallel/graphpart.py``, numpy only).

The port's own copy of the JAX package's partitioner, function for
function: the same heavy-edge matching, greedy graph growing, FM
refinement and the same ``default_rng(seed)`` draws, so a decomposition
equals JAX's cell for cell (``tests/test_torch_graphpart.py`` pins it).

OpenFOAM's ``decomposePar`` honors ``method scotch/metis/kahip`` for any
case the reference solver runs under
(``TJunction/system/decomposeParDict:17-24`` shows the dict surface; the
solver itself is decomposition-agnostic, ``cudaParticlesPimpleFoam.C:
110-119``).  Those are multilevel graph partitioners; this module
implements the same scheme — recursive bisection where each bisection is

1. **coarsening** by heavy-edge handshake matching (mutual-proposal
   rounds, fully vectorized over the CSR adjacency),
2. an **initial partition** on the coarsest graph by greedy graph
   growing (BFS by accumulated vertex weight from several seed
   candidates, best cut kept), and
3. **Kernighan-Lin style boundary refinement** during uncoarsening
   (passes of exact-gain greedy moves with a balance constraint,
   reverting a pass that does not improve the cut),

on the cell-adjacency graph (one vertex per cell, one unit-weight edge
per internal face; coarse levels carry merged vertex/edge weights).
Host-side numpy — the partition runs once at case setup, like
``decomposePar`` itself.

The resulting cell->device map feeds :func:`.flowshard.decompose`'s
``cell_map`` path, whose halo machinery accepts arbitrary maps (one
exchange round per observed device-id delta).
"""

from __future__ import annotations

import numpy as np

# refinement tolerance: a side may exceed its target weight by this
# factor (decomposePar's default graph partitioners balance to a few %)
UB = 1.05


def csr_from_faces(n_cells: int, owner_int, neighbour):
    """CSR cell-adjacency from internal faces (duplicate faces between
    the same cell pair merge into one edge of weight = face multiplicity)."""
    o = np.asarray(owner_int, np.int64)
    n = np.asarray(neighbour, np.int64)
    u = np.concatenate([o, n])
    v = np.concatenate([n, o])
    # merge parallel edges
    key = u * n_cells + v
    uk, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    uu = (uk // n_cells).astype(np.int64)
    vv = (uk % n_cells).astype(np.int64)
    w = cnt.astype(np.float64)
    order = np.argsort(uu, kind="stable")
    uu, vv, w = uu[order], vv[order], w[order]
    xadj = np.zeros(n_cells + 1, np.int64)
    np.add.at(xadj, uu + 1, 1)
    xadj = np.cumsum(xadj)
    return xadj, vv, w


def _row_ids(xadj):
    n = len(xadj) - 1
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(xadj))


def _argmax_per_row(xadj, key):
    """Index (into adjncy) of each CSR row's max-key entry; -1 for empty
    rows.  One lexsort — vectorized argmax-by-segment."""
    n = len(xadj) - 1
    rows = _row_ids(xadj)
    perm = np.lexsort((key, rows))
    out = np.full(n, -1, np.int64)
    ends = xadj[1:] - 1
    nonempty = np.diff(xadj) > 0
    out[nonempty] = perm[ends[nonempty]]
    return out


def _hem_matching(xadj, adjncy, adjwgt, rng, rounds: int = 4):
    """Heavy-edge handshake matching: each unmatched vertex proposes its
    max-weight unmatched neighbor; mutual proposals match.  Returns
    match[v] = partner (or v itself when unmatched)."""
    n = len(xadj) - 1
    match = np.full(n, -1, np.int64)
    rows = _row_ids(xadj)
    jitter = rng.random(len(adjncy)) * 1e-6
    for _ in range(rounds):
        free = match < 0
        if not free.any():
            break
        valid = free[adjncy] & free[rows]
        key = np.where(valid, adjwgt + jitter, -1.0)
        cand_e = _argmax_per_row(xadj, key)
        cand = np.full(n, -1, np.int64)
        ok = cand_e >= 0
        ok[ok] &= key[cand_e[ok]] > 0.0
        cand[ok] = adjncy[cand_e[ok]]
        # mutual handshake
        has = cand >= 0
        mutual = np.zeros(n, bool)
        idx = np.nonzero(has)[0]
        mutual[idx] = cand[cand[idx]] == idx
        pair = mutual & (np.arange(n) < cand)
        us = np.nonzero(pair)[0]
        match[us] = cand[us]
        match[cand[us]] = us
    un = match < 0
    match[un] = np.nonzero(un)[0]
    return match


def _contract(xadj, adjncy, adjwgt, vwgt, match):
    """Contract matched pairs into a coarse graph; returns
    (cmap, xadj_c, adjncy_c, adjwgt_c, vwgt_c)."""
    n = len(vwgt)
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    vwgt_c = np.zeros(nc, vwgt.dtype)
    np.add.at(vwgt_c, cmap, vwgt)
    rows = cmap[_row_ids(xadj)]
    cols = cmap[adjncy]
    keep = rows != cols
    key = rows[keep] * nc + cols[keep]
    uk, inv = np.unique(key, return_inverse=True)
    w_c = np.zeros(len(uk), np.float64)
    np.add.at(w_c, inv, adjwgt[keep])
    uu = (uk // nc).astype(np.int64)
    vv = (uk % nc).astype(np.int64)
    xadj_c = np.zeros(nc + 1, np.int64)
    np.add.at(xadj_c, uu + 1, 1)
    xadj_c = np.cumsum(xadj_c)
    return cmap, xadj_c, vv, w_c, vwgt_c


def _grow_partition(xadj, adjncy, vwgt, w_target0, seed_v):
    """Greedy graph growing: BFS from ``seed_v`` until side 0 reaches its
    target weight."""
    n = len(vwgt)
    part = np.ones(n, np.int8)
    seen = np.zeros(n, bool)
    frontier = [int(seed_v)]
    seen[seed_v] = True
    w0 = 0.0
    while w0 < w_target0:
        if not frontier:
            # disconnected component exhausted: jump to an unseen vertex
            unseen = np.nonzero(~seen)[0]
            if len(unseen) == 0:
                break
            frontier = [int(unseen[0])]
            seen[unseen[0]] = True
        nxt = []
        for v in frontier:
            if w0 >= w_target0:
                break
            part[v] = 0
            w0 += vwgt[v]
            for e in range(xadj[v], xadj[v + 1]):
                u = adjncy[e]
                if not seen[u]:
                    seen[u] = True
                    nxt.append(int(u))
        frontier = nxt
    return part


def _pseudo_peripheral(xadj, adjncy, v0, sweeps: int = 2):
    """Approximate graph-diameter endpoint: repeated BFS to the farthest
    vertex (the classic growing-seed heuristic)."""
    n = len(xadj) - 1
    v = int(v0)
    for _ in range(sweeps):
        dist = np.full(n, -1, np.int64)
        dist[v] = 0
        frontier = [v]
        last = v
        while frontier:
            nxt = []
            for u in frontier:
                for e in range(xadj[u], xadj[u + 1]):
                    w = adjncy[e]
                    if dist[w] < 0:
                        dist[w] = dist[u] + 1
                        nxt.append(int(w))
            if nxt:
                last = nxt[-1]
            frontier = nxt
        v = last
    return v


def _cut_of(xadj, adjncy, adjwgt, part):
    rows = _row_ids(xadj)
    return float(adjwgt[part[rows] != part[adjncy]].sum()) / 2.0


def _refine(xadj, adjncy, adjwgt, vwgt, part, w_target0, max_passes=10):
    """Fiduccia-Mattheyses boundary refinement: passes of single-vertex
    moves in descending-gain order with incremental gain updates, each
    vertex moved at most once per pass, hill-climbing allowed (negative
    gains accepted), balance-constrained; the pass rolls back to its
    best-cut prefix.  Stops when a pass yields no improvement."""
    import heapq

    n = len(vwgt)
    rows = _row_ids(xadj)
    w_tot = float(vwgt.sum())
    w_max0 = w_target0 * UB
    w_max1 = (w_tot - w_target0) * UB
    cut = _cut_of(xadj, adjncy, adjwgt, part)
    for _ in range(max_passes):
        same = part[rows] == part[adjncy]
        ext = np.zeros(n)
        np.add.at(ext, rows, np.where(same, 0.0, adjwgt))
        intr = np.zeros(n)
        np.add.at(intr, rows, np.where(same, adjwgt, 0.0))
        gain = ext - intr
        w0 = float(vwgt[part == 0].sum())
        # seed the queue with the boundary; interior vertices enter as
        # neighbor moves raise their gain
        heap = [(-gain[v], int(v)) for v in np.nonzero(ext > 0)[0]]
        heapq.heapify(heap)
        locked = np.zeros(n, bool)
        inq = np.zeros(n, bool)
        inq[ext > 0] = True
        moves = []
        best_cut, best_len, cur = cut, 0, cut
        # classic FM moves every vertex per pass; cap the fruitless tail
        # so fine-level passes stay near the boundary (O(cut), not O(n))
        stall_limit = 1000 + n // 20
        while heap and len(moves) - best_len < stall_limit:
            g, v = heapq.heappop(heap)
            if locked[v]:
                continue
            if -g != gain[v]:          # stale entry: reinsert fresh
                heapq.heappush(heap, (-gain[v], v))
                continue
            if part[v] == 0:
                if w_tot - (w0 - vwgt[v]) > w_max1:
                    locked[v] = True
                    continue
                part[v], w0 = 1, w0 - vwgt[v]
            else:
                if w0 + vwgt[v] > w_max0:
                    locked[v] = True
                    continue
                part[v], w0 = 0, w0 + vwgt[v]
            locked[v] = True
            cur -= gain[v]
            moves.append(v)
            if cur < best_cut - 1e-12:
                best_cut, best_len = cur, len(moves)
            # FM gain update: edge (u, v) flipped internal<->external for
            # u (v now on part[v]: same side -> newly internal, -2w)
            for e in range(xadj[v], xadj[v + 1]):
                u = adjncy[e]
                if locked[u]:
                    continue
                gain[u] += (
                    -2.0 if part[u] == part[v] else 2.0
                ) * adjwgt[e]
                inq[u] = True
                heapq.heappush(heap, (-gain[u], int(u)))
        # roll back past the best prefix
        for v in moves[best_len:]:
            part[v] = 1 - part[v]
        if best_cut >= cut - 1e-12:
            break
        cut = best_cut
    return part


def _rebalance(xadj, adjncy, adjwgt, vwgt, part, w_target0):
    """Force the bisection inside the UB balance envelope: move min-loss
    boundary vertices from the heavy side until both sides fit (FM only
    REFUSES balance-violating moves; the coarse initial partition can
    start outside the envelope)."""
    n = len(vwgt)
    rows = _row_ids(xadj)
    w_tot = float(vwgt.sum())
    limits = (w_target0 * UB, (w_tot - w_target0) * UB)
    for _ in range(n):
        w0 = float(vwgt[part == 0].sum())
        heavy = 0 if w0 > limits[0] else (1 if w_tot - w0 > limits[1] else -1)
        if heavy < 0:
            break
        same = part[rows] == part[adjncy]
        ext = np.zeros(n)
        np.add.at(ext, rows, np.where(same, 0.0, adjwgt))
        intr = np.zeros(n)
        np.add.at(intr, rows, np.where(same, adjwgt, 0.0))
        gain = ext - intr
        cand = np.nonzero((part == heavy) & (ext > 0))[0]
        if len(cand) == 0:
            cand = np.nonzero(part == heavy)[0]
        if len(cand) == 0:
            break
        # move a batch of the least-damaging vertices, then re-measure
        over = (w0 - limits[0]) if heavy == 0 else (w_tot - w0 - limits[1])
        order = cand[np.argsort(-gain[cand], kind="stable")]
        csum = np.cumsum(vwgt[order])
        take = int(np.searchsorted(csum, over) + 1)
        part[order[:take]] = 1 - heavy
    return part


def _geom_split(coords, vwgt, frac0):
    """RCB-style candidate: coordinate-rank split along the largest-
    extent axis at the weighted ``frac0`` quantile."""
    ext = coords.max(axis=0) - coords.min(axis=0)
    axis_c = int(np.argmax(ext))
    order = np.argsort(coords[:, axis_c], kind="stable")
    csum = np.cumsum(vwgt[order])
    k = int(np.searchsorted(csum, frac0 * csum[-1]))
    part = np.ones(len(vwgt), np.int8)
    part[order[: k + 1]] = 0
    return part


def _bisect(xadj, adjncy, adjwgt, vwgt, frac0, rng, coords=None,
            coarse_to: int = 96):
    """One multilevel bisection; returns a 0/1 side array.  ``frac0`` is
    side 0's share of the total vertex weight.  ``coords`` (optional
    [n, 3] cell centres) adds an RCB-style geometric candidate at the
    FINEST level — FM-refined, so the accepted bisection's cut is never
    worse than the geometric split's (best-of across all candidates)."""
    levels = [(xadj, adjncy, adjwgt, vwgt)]
    cmaps = []
    while len(levels[-1][3]) > coarse_to:
        xa, ad, aw, vw = levels[-1]
        match = _hem_matching(xa, ad, aw, rng)
        if (match == np.arange(len(vw))).mean() > 0.85:
            break  # matching stalled (star graphs); refine from here
        cmap, xa2, ad2, aw2, vw2 = _contract(xa, ad, aw, vw, match)
        cmaps.append(cmap)
        levels.append((xa2, ad2, aw2, vw2))

    xa, ad, aw, vw = levels[-1]
    nv = len(vw)
    w_target0 = frac0 * float(vw.sum())
    best = None
    best_cut = np.inf
    seeds = list(rng.choice(nv, size=min(4, nv), replace=False))
    # pseudo-peripheral candidates: diameter endpoints make the grown
    # region's boundary short (the standard GGP seeding)
    seeds += [
        _pseudo_peripheral(xa, ad, s) for s in seeds[: min(2, len(seeds))]
    ]
    for s in seeds:
        p = _grow_partition(xa, ad, vw, w_target0, s)
        p = _rebalance(xa, ad, aw, vw, p, w_target0)
        p = _refine(xa, ad, aw, vw, p, w_target0)
        c = _cut_of(xa, ad, aw, p)
        if c < best_cut:
            best, best_cut = p, c
    part = best
    for lvl in range(len(cmaps) - 1, -1, -1):
        part = part[cmaps[lvl]]
        xa, ad, aw, vw = levels[lvl]
        wt0 = frac0 * float(vw.sum())
        part = _rebalance(xa, ad, aw, vw, part, wt0)
        part = _refine(xa, ad, aw, vw, part, wt0)
    if coords is not None:
        xa, ad, aw, vw = levels[0]
        wt0 = frac0 * float(vw.sum())
        geo = _geom_split(coords, vw, frac0)
        geo = _rebalance(xa, ad, aw, vw, geo, wt0)
        geo = _refine(xa, ad, aw, vw, geo, wt0)
        if _cut_of(xa, ad, aw, geo) < _cut_of(xa, ad, aw, part):
            part = geo
    return part


def partition_graph(xadj, adjncy, adjwgt, n_parts: int, vwgt=None,
                    seed: int = 0, coords=None) -> np.ndarray:
    """Partition a CSR graph into ``n_parts`` balanced parts by
    multilevel recursive bisection; returns part[v] in [0, n_parts).
    ``coords`` (optional [n, 3]) adds a refined geometric candidate per
    bisection — the result's edge-cut then dominates plain RCB's."""
    n = len(xadj) - 1
    if vwgt is None:
        vwgt = np.ones(n)
    rng = np.random.default_rng(seed)
    part = np.zeros(n, np.int64)

    def recurse(ids, k, base):
        if k <= 1 or len(ids) == 0:
            part[ids] = base
            return
        k1 = k // 2
        # subgraph extraction
        sub_of = np.full(n, -1, np.int64)
        sub_of[ids] = np.arange(len(ids))
        rows_g = _row_ids(xadj)
        in_sub = (sub_of[rows_g] >= 0) & (sub_of[adjncy] >= 0)
        rs, cs, ws = (sub_of[rows_g[in_sub]], sub_of[adjncy[in_sub]],
                      adjwgt[in_sub])
        order = np.argsort(rs, kind="stable")
        rs, cs, ws = rs[order], cs[order], ws[order]
        xa = np.zeros(len(ids) + 1, np.int64)
        np.add.at(xa, rs + 1, 1)
        xa = np.cumsum(xa)
        side = _bisect(
            xa, cs, ws, vwgt[ids], k1 / k, rng,
            coords=None if coords is None else coords[ids],
        )
        recurse(ids[side == 0], k1, base)
        recurse(ids[side == 1], k - k1, base + k1)

    recurse(np.arange(n, dtype=np.int64), n_parts, 0)
    return part


def graph_map(n_cells: int, owner_int, neighbour, n_dev: int,
              seed: int = 0, coords=None) -> np.ndarray:
    """Cell->device map by multilevel graph bisection over the
    cell-adjacency graph (the scotch/metis-parity path of
    ``read_decompose_par``).  Pass the cell centres as ``coords`` to add
    the refined-RCB candidate per bisection."""
    xadj, adjncy, adjwgt = csr_from_faces(n_cells, owner_int, neighbour)
    return partition_graph(xadj, adjncy, adjwgt, n_dev, seed=seed,
                           coords=coords)


def edge_cut(n_cells: int, owner_int, neighbour, part) -> int:
    """Number of internal faces whose two cells land on different parts
    (decomposePar's reported metric)."""
    part = np.asarray(part)
    o = np.asarray(owner_int, np.int64)
    nb = np.asarray(neighbour, np.int64)
    return int((part[o] != part[nb]).sum())
