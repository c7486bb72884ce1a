"""PyTorch port: the AMG V-cycle's tail (``amg_tail_kernel``, ``csrc/amg.cu``)
through its plain version on the CPU (``ops/amg.py:tail_plain``, reached
through ``ops/amg_cuda.amg_tail`` on CPU tensors).

The tail runs the levels from ``tail_start`` down, the coarsest's sweeps and
the same levels back up in one launch.  At every split, from the coarsest
alone to the whole hierarchy, the tail's plain version composed with the
level kernels' above it equals the level-by-level plain V-cycle bit for
bit, in float32 and float64, on the duct, the shrunk TJunction and
pitzDaily, and on a shard's local hierarchy with ``valid``.
``fv.vcycle_levels`` through the tail matches JAX's V-cycle and AMG-CG
within 1e-12 with equal CG counts.  The kernel's descriptor (field order,
at most 16 levels) and its layout are checked on the host."""

from torch_port_common import CPU, FLOW_CASES, PITZ_BMD, make_flow_case, shrink_tjunction

import ctypes  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh  # noqa: E402
from cudaparticlesfoam_tpu.models import fv as jfv  # noqa: E402
from cudaparticlesfoam_tpu_torch import convert  # noqa: E402
from cudaparticlesfoam_tpu_torch.io import blockmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv  # noqa: E402
from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda, amg_tail  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}
JAX_TOL = 1e-12      # float64, relative to the largest magnitude of JAX's result

# level sizes of the hierarchies the card runs (chip_smoke.py 14a)
PITZ_SIZES = [12_225, 6_116, 3_077, 1_557, 802, 417, 218, 116]
TJ_SIZES = [248_000, 124_000, 62_000, 31_000, 15_500, 7_750, 3_875, 1_938, 970, 486, 245, 124]
BOX_SIZES = [65_536 >> k for k in range(10)]


@pytest.fixture(scope="module")
def polys(tmp_path_factory):
    """{name: port PolyMesh} of the duct of FLOW_CASES, the shrunk
    TJunction (2,080 cells), pitzDaily (12,225 cells) and a ragged box
    (23 x 11 x 7 = 1,771 cells)."""
    assert "duct" in FLOW_CASES
    duct = make_flow_case(tmp_path_factory.mktemp("tail"), "duct")
    tj = shrink_tjunction(tmp_path_factory.mktemp("tail_tj"))
    out = {name: blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
           for name, case in (("duct", duct), ("tjunction", tj))}
    out["pitzDaily"] = blockmesh.generate(PITZ_BMD)
    out["box"] = blockmesh.generate(_box_dict(tmp_path_factory.mktemp("tail_box"), 23, 11, 7))
    return out


def _box_dict(dst, nx, ny, nz):
    """The blockMeshDict of a box of nx x ny x nz unit hex cells."""
    path = os.path.join(dst, "blockMeshDict")
    with open(path, "w") as fh:
        fh.write(
            "FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }\n"
            "convertToMeters 1;\n"
            f"vertices ( (0 0 0) ({nx} 0 0) ({nx} {ny} 0) (0 {ny} 0) (0 0 {nz}) ({nx} 0 {nz}) "
            f"({nx} {ny} {nz}) (0 {ny} {nz}) );\n"
            f"blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading (1 1 1) );\n"
            "boundary ( walls { type wall; faces ((0 4 7 3) (1 2 6 5) (0 1 5 4) (3 7 6 2) "
            "(0 3 2 1) (4 5 6 7)); } );\n")
    return path


MIN_COARSE = {"duct": 20, "tjunction": 200, "pitzDaily": 200, "box": 20}


def _hierarchy(pm, name, dtype, seed):
    """The kernels' view of a hierarchy (rows, aggs, ops, prolong) under a
    pressure-like matrix from ``seed``, and a residual."""
    m = fv.fv_mesh(pm, dtype=dtype, device=CPU)
    h = fv.build_amg(m, min_coarse=MIN_COARSE[name])
    rng = np.random.default_rng(seed)
    off = -torch.as_tensor(rng.uniform(0.5, 2.0, m.n_internal), dtype=dtype)
    diag = fv.index_sum(m.n_cells, [(m.own_i, -off), (m.neighbour, -off)],
                        out=torch.as_tensor(rng.uniform(0.1, 1.0, m.n_cells), dtype=dtype))
    A = fv.FvMatrix(diag=diag, lower=off, upper=off, source=torch.zeros(m.n_cells, 1, dtype=dtype))
    rows = [amg.row_plan(m.n_cells, m.own_i, m.neighbour)] + [
        amg.row_plan(n, o, ne) for n, o, ne in zip(h.sizes, h.owners, h.neighs)]
    aggs = [amg.agg_plan(n, a) for n, a in zip(h.sizes, h.aggs)]
    ops = [(A.diag, A.upper)] + list(fv.amg_coarse_ops(m, h, A))
    prolong = [(a, None) for a in h.aggs]
    return rows, aggs, ops, prolong, torch.as_tensor(rng.standard_normal(m.n_cells), dtype=dtype)


def _levels_plain(rows, aggs, ops, prolong, r):
    """The V-cycle level by level, as the level kernels ran it: the plain
    down of every level, the coarsest's sweeps, the plain up back."""
    rs = [r]
    for li, ag in enumerate(aggs):
        rs.append(amg.down_plain(rows[li], ag, *ops[li], rs[li]))
    x = amg.coarsest_plain(rows[-1], *ops[-1], rs[-1])
    for li in reversed(range(len(aggs))):
        agg, valid = prolong[li]
        x = amg.up_plain(rows[li], *ops[li], rs[li], agg, x, valid)
    return x


def _split_plain(rows, aggs, ops, prolong, r, t):
    """The V-cycle with the tail from level t: plain downs above it,
    ``tail_plain``, plain ups back."""
    rs = [r]
    for li in range(t):
        rs.append(amg.down_plain(rows[li], aggs[li], *ops[li], rs[li]))
    x = amg.tail_plain(rows[t:], aggs[t:], ops[t:], prolong[t:], rs[t])
    for li in reversed(range(t)):
        agg, valid = prolong[li]
        x = amg.up_plain(rows[li], *ops[li], rs[li], agg, x, valid)
    return x


# ---------------------------------------------------------------------------
# the tail plan (ops/amg_tail.py) walked as amg_tail_kernel walks it
# ---------------------------------------------------------------------------

def _segment(plan, k, b):
    """Block b's segment of level k, its fields cut to the block's counts."""
    lp = plan.levels[k]
    s = plan.h_blob[lp.base + b * lp.seg: lp.base + (b + 1) * lp.seg].astype(np.int64)
    rows, terms, nmem, npmem = s[:4]
    f = lambda name, n: s[lp.at[name]: lp.at[name] + n]  # noqa: E731
    top = k == 0 and plan.cluster >= 1       # hdr[2] counts the top's distinct neighbours
    return dict(rows=rows, toff=f("toff", rows + 1), addr=f("addr", terms),
                moff=f("moff", rows + 1), mem=f("mem", 0 if top else nmem),
                poff=f("poff", rows + 1), pmem=f("pmem", npmem), grow=f("grow", rows),
                ldst=f("ldst", lp.lower), cpos=f("cpos", terms),
                tslot=f("tslot", terms if top else 0), nbr=f("nbr", nmem if top else 0))


def _fold(toff, terms, dtype):
    """sum_row terms from 0, left to right, of the rows of ``toff``."""
    lens = np.diff(toff)
    acc = torch.zeros(len(lens), dtype=dtype)
    for j in range(int(lens.max(initial=0))):
        at = np.flatnonzero(lens > j)
        acc[at] = acc[at] + terms[toff[at] + j]
    return acc


def _walk(plan, ops, valids, r_top, omega=amg.OMEGA, sweeps=amg.COARSEST_SWEEPS):
    """The tail as the kernel runs it from ``plan``: each block's shared
    memory a dict of vectors indexed by slot, the top's r, s and each
    term's neighbour s gathered in the prologue, the cluster restrictions
    over each block's own members with neighbours read by packed address,
    level P's r1 and s into block 0, block 0's levels, x' of level P into
    its owners, the cluster levels back up through each row's prolongation
    members, the top's x' in a global vector.  Returns the top's x."""
    T = r_top.dtype
    om = torch.tensor(omega, dtype=T)
    K, C = len(plan.sizes), plan.cluster
    P, NB = C - 1, amg_tail.TAIL_BLOCKS
    seg = {(k, b): _segment(plan, k, b) for k in range(K) for b in range(NB if k < C else 1)}
    smem = [dict() for _ in range(NB)]
    for (k, b) in seg:
        if k or not C:
            smem[b][k] = [torch.zeros(plan.levels[k].cap_rows, dtype=T) for _ in "rv"]
    unpack = lambda a: zip(a >> amg_tail.SLOT_BITS, a & ((1 << amg_tail.SLOT_BITS) - 1))  # noqa
    out, d0 = torch.zeros(plan.sizes[0], dtype=T), ops[0][0]
    if C:
        xs, top = torch.zeros(plan.sizes[0], dtype=T), {}
        for b in range(NB):
            g, a = seg[(0, b)]["grow"], seg[(0, b)]["addr"]
            top[b] = (r_top[g], (om * r_top[g]) / d0[g], (om * r_top[a]) / d0[a])
    else:
        smem[0][0] = [r_top.clone(), (om * r_top) / d0]

    def nbr(k, b, a, which):
        """The values of level k's terms ``a`` of block b (s or x')."""
        if k < C:
            return torch.stack([smem[o][k][1][s] for o, s in unpack(a)]) if len(a) else \
                torch.zeros(0, dtype=T)
        return smem[0][k][1][a]

    def r1_rows(k, b):
        s, (dg, off) = seg[(k, b)], ops[k]
        if k == 0 and C:
            r, sm, nb = top[b]
        else:
            r, sm = (v[: s["rows"]] for v in smem[b][k])
            nb = nbr(k, b, s["addr"], 1)
        return r - (dg[s["grow"]] * sm + _fold(s["toff"], off[s["cpos"]] * nb, T)), sm

    def restrict(kc, b, vals):
        s = seg[(kc, b)]
        acc = _fold(s["moff"], vals[s["mem"]], T)
        smem[b][kc][0][: s["rows"]] = acc
        smem[b][kc][1][: s["rows"]] = (om * acc) / ops[kc][0][s["grow"]]

    for k in range(C - 1):
        r1 = {b: r1_rows(k, b)[0] for b in range(NB)}
        for b in range(NB):
            restrict(k + 1, b, r1[b])
    if C:
        R1, SP = torch.zeros(plan.sizes[P], dtype=T), torch.zeros(plan.sizes[P], dtype=T)
        for b in range(NB):
            g = seg[(P, b)]["grow"]
            R1[g], SP[g] = r1_rows(P, b)
        restrict(C, 0, R1)
    for k in range(C, K - 1):
        restrict(k + 1, 0, r1_rows(k, 0)[0])

    def expand(k, b, x):
        s = seg[(k, b)]
        if k == 0:
            out[s["grow"]] = x
            return
        j = s["pmem"]
        xp, valid = x[np.repeat(np.arange(s["rows"]), np.diff(s["poff"]))], valids[k - 1]
        if k == C:
            xp = SP[j] + (xp * valid[j] if valid is not None else xp)
            if P == 0:
                xs[j] = xp
            for (o, sl), v in zip(unpack(s["ldst"][j]) if P else (), xp):
                smem[o][P][1][sl] = v
            return
        g = seg[(k - 1, b)]["grow"][j]
        add = xp * valid[g] if valid is not None else xp
        if k == 1 and C >= 2:
            xs[g] = top[b][1][j] + add
        else:
            v = smem[b][k - 1][1]
            v[j] = v[j] + add

    def smooth(k, b):
        s, (dg, off) = seg[(k, b)], ops[k]
        if k == 0 and C:
            x, r, nb = xs[s["grow"]], top[b][0], xs[s["addr"]]
        else:
            r, x = (v[: s["rows"]] for v in smem[b][k])
            nb = nbr(k, b, s["addr"], 1)
        d = dg[s["grow"]]
        return x + (om * (r - (d * x + _fold(s["toff"], off[s["cpos"]] * nb, T)))) / d

    z, (dg, off) = seg[(K - 1, 0)], ops[K - 1]
    r, a = smem[0][K - 1][0], smem[0][K - 1][1].clone()
    for _ in range(sweeps):
        a = a + (om * (r - (dg * a + _fold(z["toff"], off[z["cpos"]] * a[z["addr"]], T)))) / dg
    expand(K - 1, 0, a)
    for k in range(K - 2, C - 1, -1):
        expand(k, 0, smooth(k, 0))
    for k in range(C - 1, -1, -1):
        up = {b: smooth(k, b) for b in range(NB)}
        for b in range(NB):
            expand(k, b, up[b])
    return out


def _plan_splits(rows, aggs, ops, prolong, r, block0_rows):
    """(split, plan, walked, tail_plain) at every split t = L .. 0."""
    rs = [r]
    for k, ag in enumerate(aggs):
        rs.append(amg.down_plain(rows[k], ag, *ops[k], rs[k]))
    for t in range(len(aggs), -1, -1):
        plan = amg_tail.tail_plan(rows[t:], aggs[t:], prolong[t:], block0_rows)
        yield t, plan, _walk(plan, ops[t:], [v for _, v in prolong[t:]], rs[t]), \
            amg.tail_plain(rows[t:], aggs[t:], ops[t:], prolong[t:], rs[t])


@pytest.mark.parametrize("block0_rows", [amg_cuda.TAIL_BLOCK0_ROWS, 32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["duct", "tjunction", "pitzDaily", "box"])
def test_tail_plan_walk_equals_tail_plain_at_every_split(polys, name, dtype, block0_rows):
    """The tail plan walked as the kernel walks it (owner blocks, packed
    addresses, the staged terms in plan order, the owner's smoothed value)
    equals ``tail_plain`` bit for bit at every split, from the coarsest
    alone (all in block 0) to the whole hierarchy, on the duct, the shrunk
    TJunction, pitzDaily and a ragged box, with block 0 from 512 rows and
    from 32 (more cluster levels)."""
    rows, aggs, ops, prolong, r = _hierarchy(polys[name], name, DTYPES[dtype], 11)
    clusters = set()
    for t, plan, got, want in _plan_splits(rows, aggs, ops, prolong, r, block0_rows):
        assert torch.equal(got, want), (t, plan.cluster)
        clusters.add(plan.cluster)
    assert 0 in clusters and (max(clusters) > 0) == (rows[0].n > block0_rows)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tail_plan_walk_with_valid_on_a_shard(polys, dtype):
    """A 4-shard duct's local hierarchies (dropped ghosts: rows in no
    restriction, the clipped prolongation times ``agg_valid``): the walk
    equals ``tail_plain`` bit for bit at every split, shard by shard."""
    dt = DTYPES[dtype]
    smesh, _ = flowshard.decompose(polys["duct"], 4, dtype=dt, device=CPU)
    lamg = flowshard.build_local_amg(smesh, min_coarse=5)
    rng = np.random.default_rng(12)
    for s, sh in enumerate(smesh.shards):
        m, t = sh.m, lamg.shard[s]
        off0 = (-torch.as_tensor(rng.uniform(0.5, 2.0, m.n_internal), dtype=dt)
                * t["off_mask"])
        diag0 = fv.index_sum(m.n_cells, [(m.own_i, -off0), (m.neighbour, -off0)],
                             out=torch.as_tensor(rng.uniform(0.1, 1.0, m.n_cells), dtype=dt))
        diag0 = torch.where(sh.mask, diag0, 1.0)
        levels = flowshard._local_coarse_ops(lamg, s, m, diag0, off0)
        r0 = torch.where(sh.mask, torch.as_tensor(rng.standard_normal(m.n_cells), dtype=dt), 0.0)
        rows = [amg.row_plan(m.n_cells, m.own_i, m.neighbour)] + [
            amg.row_plan(d_.shape[0], o, ne)
            for (d_, _), o, ne in zip(levels, t["owners"], t["neighs"])]
        aggs = [amg.agg_plan(nc, a) for (nc, _), a in zip(lamg.sizes, t["aggs"])]
        prolong = list(zip(t["aggs_c"], t["agg_valid"]))
        assert any(a.h_offsets[-1] < a.n_src for a in aggs)      # dropped rows
        for block0_rows in (amg_cuda.TAIL_BLOCK0_ROWS, 8):
            for split, plan, got, want in _plan_splits(rows, aggs, [(diag0, off0)] + levels,
                                                        prolong, r0, block0_rows):
                assert torch.equal(got, want), (s, split, block0_rows)


def test_tail_plan_keeps_rows_with_their_aggregate(polys):
    """pitzDaily's tail from level 1: level P split into 16 ranges, each
    finer row in the block of its aggregate, slots dense in index order,
    the block-0 levels whole in block 0 by index; a block's rows at most
    1.1 times the mean on each cluster level above P (the ranges of level P
    balance the rows that descend to them); a row whose restriction and
    prolongation indices differ is refused; the top's distinct neighbours
    list its own rows first, each once, and reach every term's."""
    rows, aggs, ops, prolong, r = _hierarchy(polys["pitzDaily"], "pitzDaily", torch.float32, 3)
    plan = amg_tail.tail_plan(rows[1:], aggs[1:], prolong[1:], amg_cuda.TAIL_BLOCK0_ROWS)
    K, C = len(plan.sizes), plan.cluster
    assert plan.sizes == tuple(PITZ_SIZES[1:]) and C == 4
    assert np.all(np.diff(plan.owner[C - 1]) >= 0) and set(plan.owner[C - 1]) == set(range(16))
    for k in range(K):
        own, slot = plan.owner[k], plan.slot[k]
        if k + 1 < C:
            assert np.array_equal(own, plan.owner[k + 1][prolong[1 + k][0].numpy()])
        if k >= C:
            assert not own.any() and np.array_equal(slot, np.arange(plan.sizes[k]))
            continue
        counts = np.bincount(own, minlength=16)
        assert plan.levels[k].cap_rows == counts.max()
        assert k == C - 1 or counts.max() <= 1.1 * plan.sizes[k] / 16
        for b in range(16):
            assert np.array_equal(np.sort(slot[own == b]), np.arange(counts[b]))
            assert np.all(np.diff(slot[np.flatnonzero(own == b)]) > 0)
    assert 0 < plan.remote_terms < plan.cluster_terms
    for b in range(16):       # the top's distinct neighbours: own rows first, each term's
        seg = _segment(plan, 0, b)
        assert np.array_equal(seg["nbr"][: seg["rows"]], seg["grow"])
        assert np.unique(seg["nbr"]).size == seg["nbr"].size
        assert np.array_equal(seg["nbr"][seg["tslot"]], seg["addr"])
    bad = prolong[1][0].clone()
    bad[0] = (bad[0] + 1) % plan.sizes[1]
    with pytest.raises(ValueError, match="restriction and prolongation indices differ"):
        amg_tail.tail_plan(rows[1:], aggs[1:], [(bad, None)] + prolong[2:],
                           amg_cuda.TAIL_BLOCK0_ROWS)


@pytest.mark.parametrize("sizes, block0_rows, cluster", [
    (PITZ_SIZES[1:], 512, 4), (PITZ_SIZES[1:], 1024, 3), (TJ_SIZES[5:], 512, 4),
    (TJ_SIZES[5:], 1024, 3), ([116], 512, 0), ([417, 218, 116], 512, 0), ([9_000, 20], 512, 1),
])
def test_tail_phases_and_barriers(sizes, block0_rows, cluster):
    """The cluster levels and the kernel's timed phases: the prologue's four
    parts, a restriction a level, level P's residual and level C's entry, the
    coarsest, a prolongation a level; 2C cluster barriers
    (``traffic.amg_tail_chain``)."""
    from cudaparticlesfoam_tpu_torch.ops import traffic

    assert amg_tail.cluster_levels(sizes, block0_rows) == cluster
    plan = amg_tail.tail_plan(*_synthetic(sizes, 4), block0_rows)
    names = amg_tail.phases(plan)
    K = len(sizes)
    assert names[:4] == ["prologue: own gathers", "prologue: cluster start",
                         "prologue: block 0's levels", "prologue: the top's s"]
    assert names.count("coarsest") == 1 and len(names) == 2 * K + 3 + (1 if cluster else 0)
    assert [n for n in names if n.startswith("down")] == [f"down {k}" for k in range(K - 1)
                                                          if k != cluster - 1]
    assert [n for n in names if n.startswith("up")] == [f"up {k}" for k in range(K - 2, -1, -1)]
    chain = traffic.amg_tail_chain(sizes, block0_rows=block0_rows)
    assert chain["barriers"] == 2 * cluster


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["duct", "tjunction", "pitzDaily"])
def test_tail_plain_equals_level_by_level_at_every_split(polys, name, dtype):
    """From the coarsest alone (t = L) to the whole hierarchy (t = 0), bit
    for bit, through ``tail_plain`` and through the wrapper on CPU
    tensors; ``vcycle_levels`` at TAIL_ROWS 0, the default and past the
    largest level too."""
    rows, aggs, ops, prolong, r = _hierarchy(polys[name], name, DTYPES[dtype], 7)
    L = len(aggs)
    assert L >= 2
    want = _levels_plain(rows, aggs, ops, prolong, r)
    for t in range(L + 1):
        assert torch.equal(_split_plain(rows, aggs, ops, prolong, r, t), want), t
    assert torch.equal(amg_cuda.amg_tail(rows, aggs, ops, prolong, r), want)
    for tail_rows in (0, amg_cuda.TAIL_ROWS, rows[0].n):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(amg_cuda, "TAIL_ROWS", tail_rows)
            assert torch.equal(fv.vcycle_levels(rows, aggs, ops, prolong, r), want), tail_rows


@pytest.mark.parametrize("dtype", DTYPES)
def test_tail_plain_with_valid_on_a_shard(polys, dtype):
    """A 4-shard duct's local hierarchies (masked level-0 operator, padded
    levels, dropped ghosts, the clipped prolongation times ``agg_valid``):
    at every split = level by level, bit for bit, shard by shard."""
    dt = DTYPES[dtype]
    smesh, _ = flowshard.decompose(polys["duct"], 4, dtype=dt, device=CPU)
    lamg = flowshard.build_local_amg(smesh, min_coarse=5)
    assert lamg.n_levels >= 2
    rng = np.random.default_rng(8)
    for s, sh in enumerate(smesh.shards):
        m, t = sh.m, lamg.shard[s]
        off0 = (-torch.as_tensor(rng.uniform(0.5, 2.0, m.n_internal), dtype=dt)
                * t["off_mask"])
        diag0 = fv.index_sum(m.n_cells, [(m.own_i, -off0), (m.neighbour, -off0)],
                             out=torch.as_tensor(rng.uniform(0.1, 1.0, m.n_cells), dtype=dt))
        diag0 = torch.where(sh.mask, diag0, 1.0)
        levels = flowshard._local_coarse_ops(lamg, s, m, diag0, off0)
        r0 = torch.where(sh.mask, torch.as_tensor(rng.standard_normal(m.n_cells), dtype=dt), 0.0)
        rows = [amg.row_plan(m.n_cells, m.own_i, m.neighbour)] + [
            amg.row_plan(d_.shape[0], o, ne)
            for (d_, _), o, ne in zip(levels, t["owners"], t["neighs"])]
        aggs = [amg.agg_plan(nc, a) for (nc, _), a in zip(lamg.sizes, t["aggs"])]
        ops = [(diag0, off0)] + list(levels)
        prolong = list(zip(t["aggs_c"], t["agg_valid"]))
        assert all(v is not None for _, v in prolong)
        want = _levels_plain(rows, aggs, ops, prolong, r0)
        for split in range(lamg.n_levels + 1):
            assert torch.equal(_split_plain(rows, aggs, ops, prolong, r0, split), want), \
                (s, split)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fv, "_FIXED_ORDER_ON_CPU", True)
            assert torch.equal(flowshard._local_vcycle(lamg, s, m, diag0, off0, levels, r0),
                               want), s


@pytest.mark.parametrize("sizes, tail_rows, start", [
    (PITZ_SIZES, 16_384, 0),             # every level: one launch a V-cycle
    (TJ_SIZES, 16_384, 4),               # levels 4-11: 9 launches
    (BOX_SIZES, 16_384, 2),              # levels 2-9: 5 launches
    (PITZ_SIZES, 0, 7),                  # the coarsest alone (2L + 1 launches)
    (TJ_SIZES, 0, 11),
    (TJ_SIZES, 10**9, 0),
    ([100], 0, 0),                       # a hierarchy of one level
    ([9_000, 20_000, 4_000, 100], 16_384, 2),   # a larger level below stops the tail
    ([40] * 20, 16_384, 4),              # at most 16 levels in the tail
])
def test_tail_start(sizes, tail_rows, start):
    assert amg.tail_start(sizes, tail_rows) == start
    assert len(sizes) - start <= amg.MAX_TAIL_LEVELS


def test_tail_start_refuses_no_levels():
    with pytest.raises(ValueError):
        amg.tail_start([], 16_384)


def _struct_fields(src, name):
    """The field names of ``struct name { ... };`` in a CUDA source."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", src, re.S).group(1)
    out = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            out += [re.findall(r"\w+", w.split("[")[0])[-1] for w in decl.split(",")]
    return out


def test_descriptor_matches_the_kernel_struct():
    """``csrc/amg.cu``'s TailLevel and TailParams field for field: three
    pointers then 28 int32 a level (136 B); six pointers, omega, ten
    int32, then 16 levels (2,272 B, under the 4 KB of kernel parameters)."""
    with open(os.path.join(os.path.dirname(amg.__file__), "..", "csrc", "amg.cu")) as fh:
        src = fh.read()
    assert [f[0] for f in amg_cuda.TailLevel._fields_] == _struct_fields(src, "TailLevel")
    assert [f[0] for f in amg_cuda.TailParams._fields_] == _struct_fields(src, "TailParams")
    assert [f[0] for f in amg_cuda.TailLevel._fields_][10:20] == list(amg_tail.FIELDS[1:-1])
    assert ctypes.sizeof(amg_cuda.TailLevel) == 136
    assert amg_cuda.TailParams.lv.offset == 96
    assert ctypes.sizeof(amg_cuda.TailParams) == 96 + 16 * 136 < 4096
    assert "constexpr int TAIL_MAX_LEVELS = 16;" in src and amg.MAX_TAIL_LEVELS == 16
    assert f"constexpr int TAIL_SMEM_MAX = {amg_cuda.TAIL_SMEM_BYTES};" in src
    assert f"constexpr int TAIL_THREADS = {amg_cuda.TAIL_THREADS};" in src
    assert f"constexpr int TAIL_BLOCKS = {amg_cuda.TAIL_BLOCKS};" in src
    assert f"constexpr int TAIL_SLOT_BITS = {amg_tail.SLOT_BITS};" in src


def _chain(n_levels, rows=40):
    """A chain of ``n_levels`` 1-d levels of ``rows`` rows, pairs
    aggregated, on the CPU."""
    out = []
    for _ in range(n_levels):
        own = torch.arange(rows - 1)
        out.append((amg.row_plan(rows, own, own + 1), torch.arange(rows) // 2))
    return out


def test_descriptor_fills_every_level_and_raises_past_16():
    levels = _chain(4)
    rows = [p for p, _ in levels]
    aggs = [amg.agg_plan(40, a) for _, a in levels[:-1]]
    ops = [(torch.ones(40), torch.full((39,), -0.1)) for _ in levels]
    prolong = [(a, None) for _, a in levels[:-1]]
    r, x, xs = torch.ones(40), torch.empty(40), torch.empty(40)
    plan = amg_tail.tail_plan(rows, aggs, prolong, 16)
    assert plan.cluster == 3 and amg_tail.tail_plan(rows, aggs, prolong, 16) is plan
    lay = amg_cuda.tail_layout(plan, 4)
    assert all(lay.stage)
    p = amg_cuda.tail_params(plan, lay, ops, prolong, r, x, xs)
    assert (p.levels, p.cluster, p.lower) == (4, 3, 40)
    assert p.sweeps == amg.COARSEST_SWEEPS and p.omega == amg.OMEGA and p.stamps is None
    assert (p.r_top, p.x_out, p.xs, p.blob) == (r.data_ptr(), x.data_ptr(), xs.data_ptr(),
                                                plan.blob.data_ptr())
    assert (p.xb, p.r1, p.sp) == (lay.xb, lay.r1, lay.sp)
    for k in range(4):
        lv, lp = p.lv[k], plan.levels[k]
        assert (lv.diag, lv.off, lv.valid) == (ops[k][0].data_ptr(), ops[k][1].data_ptr(), None)
        assert (lv.n, lv.stage, lv.cap_rows, lv.cap_terms) == (40, 1, lp.cap_rows, lp.cap_terms)
        assert (lv.base, lv.seg, lv.copy) == (lp.base, lp.seg, lp.copy)
        assert [getattr(lv, f) for f in amg_tail.FIELDS[1:-1]] == [lp.at[f] for f in
                                                                   amg_tail.FIELDS[1:-1]]
        assert (lv.st, lv.coef, lv.sdiag, lv.r, lv.v) == (lay.st[k], lay.coef[k], lay.diag[k],
                                                          lay.r[k], lay.v[k])
        assert lv.svalid == -1 and lv.lvalid == -1
    assert p.lv[4].off is None and p.lv[4].n == 0
    with pytest.raises(ValueError, match="x' scratch"):
        amg_cuda.tail_params(plan, lay, ops, prolong, r, x)
    many = _chain(17)
    args = ([q for q, _ in many], [amg.agg_plan(40, a) for _, a in many[:-1]],
            [(torch.ones(40), torch.full((39,), -0.1))] * 17, [(a, None) for _, a in many[:-1]])
    with pytest.raises(ValueError, match="1 to 16 levels"):
        amg_tail.tail_plan(args[0], args[1], args[3], 16)
    with pytest.raises(ValueError, match="1 to 16 levels"):
        amg_cuda.amg_tail(*args, r)
    with pytest.raises(ValueError, match="takes 4 ops"):
        amg_cuda.tail_params(plan, lay, ops[:3], prolong, r, x, xs)


def _synthetic(sizes, terms):
    """A hierarchy of 1-d levels of ``sizes`` rows, each row joined to
    its ``terms // 2`` nearest on either side, level k's row i aggregated
    into i * n_{k+1} // n_k: (rows, aggs, prolong), on the CPU."""
    w = max(1, terms // 2)
    rows, aggs, prolong = [], [], []
    for k, n in enumerate(sizes):
        own = torch.cat([torch.arange(max(n - d, 0)) for d in range(1, w + 1)])
        nei = torch.cat([torch.arange(d, max(n, d)) for d in range(1, w + 1)])
        rows.append(amg.row_plan(n, own, nei))
        if k + 1 < len(sizes):
            a = torch.arange(n) * sizes[k + 1] // n
            aggs.append(amg.agg_plan(sizes[k + 1], a))
            prolong.append((a, None))
    return rows, aggs, prolong


def _spans(plan, lay):
    """(start, bytes, what) of everything the layout places in a block's
    shared memory."""
    K, e = len(plan.sizes), lay.elem
    out = [(lay.xb, plan.sizes[-1] * e, "xb")]
    if plan.cluster:
        nP = plan.sizes[plan.cluster - 1]
        out += [(lay.r1, nP * e, "r1"), (lay.sp, nP * e, "sp")]
    for k, lp in enumerate(plan.levels):
        if lay.r[k] >= 0:
            out += [(lay.r[k], lp.cap_rows * e, f"r{k}"), (lay.v[k], lp.cap_rows * e, f"v{k}")]
        if not lay.stage[k]:
            continue
        top = k == 0 and plan.cluster >= 1
        out += [(lay.st[k], 4 * lp.copy, f"st{k}"), (lay.coef[k], lp.cap_terms * e, f"coef{k}"),
                (lay.diag[k], (lp.cap_nbrs if top else lp.cap_rows) * e, f"diag{k}")]
        if lay.valid[k] >= 0:
            out.append((lay.valid[k], lp.cap_rows * e, f"valid{k}"))
        if lay.sv[k] >= 0:
            assert lay.ss[k] == lay.sv[k]
            out += [(lay.sr[k], lp.cap_nbrs * e, "sr"), (lay.sv[k], lp.cap_nbrs * e, "sv")]
        if lay.lvalid[k] >= 0:
            out.append((lay.lvalid[k], lp.lower * e, "lvalid"))
    assert len(out) >= K
    return sorted(out)


@pytest.mark.parametrize("sizes, elem", [(PITZ_SIZES, 8), (TJ_SIZES[4:], 8), (BOX_SIZES[2:], 8),
                                         (PITZ_SIZES, 4), ([116], 8), ([3, 2, 1], 4)])
def test_layout_places_every_vector_apart(sizes, elem):
    """Every vector and staged segment of the layout lies apart from the
    others, 16 B aligned, within a block's shared memory; the vectors come
    first; the plan's segments lie apart in its words, the copied part of
    each a multiple of 16 B; a tail from at most TAIL_ROWS rows (7 terms a
    row) fits with every level staged in float32."""
    plan = amg_tail.tail_plan(*_synthetic(sizes, 7), amg_cuda.TAIL_BLOCK0_ROWS)
    for valid in (False, True):
        lay = amg_cuda.tail_layout(plan, elem, valid)
        spans = _spans(plan, lay)
        assert spans[0][0] == 0 and all(a % 16 == 0 for a, _, _ in spans)
        assert all(a + n <= b for (a, n, _), (b, _, _) in zip(spans, spans[1:])), spans
        end = max(a + n for a, n, _ in spans)
        assert end <= lay.smem < end + 16 and lay.smem <= amg_cuda.TAIL_SMEM_BYTES
        assert lay.vectors <= min(lay.st[k] for k in range(len(sizes)) if lay.stage[k]) \
            if any(lay.stage) else True
        assert 32 <= lay.threads <= amg_cuda.TAIL_THREADS and lay.threads % 32 == 0
        if elem == 4 and sizes[0] <= amg_cuda.TAIL_ROWS:
            assert all(lay.stage)
    base = 0
    for lp in plan.levels:
        assert lp.base == base and lp.seg % 4 == 0 and lp.copy % 4 == 0 and lp.copy <= lp.seg
        at = [lp.at[f] for f in amg_tail.FIELDS]
        assert at == sorted(at) and at[0] == 0 and all(a % 4 == 0 for a in at)
        base += lp.nseg * lp.seg
    assert plan.h_blob.size == base


def _run_programs(plan, lay, ops, valids, r_top):
    """The prologue's gather programs run on the host: each block's shared
    memory as an array of ``lay.smem / elem`` values, its own program
    first, then block 0's levels' program into block 0's."""
    srcs = {3 * k + j: t for k, (d, o) in enumerate(ops)
            for j, t in enumerate((o, d, valids[k] if k < len(valids) else None))}
    srcs[amg_tail.SRC_RTOP] = r_top
    n = lay.smem // lay.elem
    mem = [torch.full((n,), float("nan"), dtype=r_top.dtype) for _ in range(16)]
    h = lay.prog.numpy().astype(np.int64).reshape(-1, 2)
    nloc = lay.prog_local
    for b in range(16):
        progs = [h[b * nloc: (b + 1) * nloc]] + ([h[16 * nloc:]] if b == 0 else [])
        for items in progs:
            src = (items[:, 0] & 0xFFFFFFFF) >> amg_tail.IDX_BITS
            idx = items[:, 0] & ((1 << amg_tail.IDX_BITS) - 1)
            for s in np.unique(src):
                if s == amg_tail.NO_SOURCE or srcs.get(int(s)) is None:
                    continue
                at = src == s
                mem[b][items[at, 1]] = srcs[int(s)][idx[at]]
    return mem


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block0_rows", [amg_cuda.TAIL_BLOCK0_ROWS, 32])
def test_gather_programs_stage_what_the_phases_read(polys, dtype, block0_rows):
    """pitzDaily's tail from level 1 (and from level 5, all in block 0):
    the prologue's gather programs, run on the host, fill each staged
    level's coefficients (off at the plan's positions) and diag, and on
    the cluster top the r and diag of each distinct neighbour, every slot a
    block's rows and terms use exactly as the segment indexes them, and
    nothing else."""
    dt = DTYPES[dtype]
    rows, aggs, ops, prolong, r = _hierarchy(polys["pitzDaily"], "pitzDaily", dt, 5)
    for t in (1, 5):
        plan = amg_tail.tail_plan(rows[t:], aggs[t:], prolong[t:], block0_rows)
        lay = amg_cuda.tail_layout(plan, r.element_size())
        assert all(lay.stage)
        K, C = len(plan.sizes), plan.cluster
        mem = _run_programs(plan, lay, ops[t:], [None] * (K - 1), r)
        e = lay.elem
        filled = [torch.zeros(lay.smem // e, dtype=torch.bool) for _ in range(16)]
        for k in range(K):
            (d, o), lp = ops[t + k], plan.levels[k]
            for b in range(16 if k < C else 1):
                seg = _segment(plan, k, b)
                want = {lay.coef[k]: o[seg["cpos"]], lay.diag[k]: d[seg["grow"]]}
                if k == 0 and C:      # every distinct neighbour's diag and r
                    want.update({lay.diag[k]: d[seg["nbr"]], lay.sr[k]: r[seg["nbr"]]})
                for at, vals in want.items():
                    got = mem[b][at // e: at // e + vals.shape[0]]
                    assert torch.equal(got, vals), (t, k, b, at)
                    filled[b][at // e: at // e + vals.shape[0]] = True
        for b in range(16):
            assert torch.isnan(mem[b][~filled[b]]).all(), b    # nothing else written
        words = lay.prog.numpy().reshape(-1, 2)
        assert words.shape[0] == 16 * lay.prog_local + lay.prog_stretch


@pytest.mark.parametrize("sizes, nnz, elem, fits", [
    (TJ_SIZES, 744, 8, False),        # the whole TJunction hierarchy in float64: 264,864 B
    (TJ_SIZES, 744, 4, True),         # in float32: 132,432 B
    (TJ_SIZES[1:], 744, 8, True),
    ([40_000], 240_000, 8, False),    # a coarsest of 40,000 rows: r, x, its second buffer
    ([9_000], 54_000, 8, True),       # 9,000 rows fit, but not the staged plan beside them
    (TJ_SIZES[5:], 868, 8, "staged"),  # from 7,750 rows in float64: 247,120 B to stage all
    (TJ_SIZES[5:], 868, 4, True),     # in float32: 175,344 B
])
def test_layout_raises_with_the_numbers_where_shared_memory_is_short(sizes, nnz, elem, fits):
    """Where a tail's vectors do not fit in a block's shared memory the
    layout raises and names the bytes, and so does it where a tail from at
    most TAIL_ROWS rows cannot stage every level; a larger tail's levels
    are staged only where they fit beside the vectors, from the coarsest
    up."""
    plan = amg_tail.tail_plan(*_synthetic(sizes, max(1, nnz // sizes[-1])),
                              amg_cuda.TAIL_BLOCK0_ROWS)
    if not fits:
        with pytest.raises(ValueError, match=f"more than its {amg_cuda.TAIL_SMEM_BYTES} B"):
            amg_cuda.tail_layout(plan, elem)
        return
    if fits == "staged":
        assert sizes[0] <= amg_cuda.TAIL_ROWS
        full = amg_tail.layout(plan, elem, False, amg_cuda.TAIL_SMEM_BYTES, 512).full
        assert full > amg_cuda.TAIL_SMEM_BYTES
        with pytest.raises(ValueError, match=f"needs {full} B of shared memory a block to stage "
                                             f"every level .* more than its "
                                             f"{amg_cuda.TAIL_SMEM_BYTES} B"):
            amg_cuda.tail_layout(plan, elem)
        return
    lay = amg_cuda.tail_layout(plan, elem)
    assert lay.vectors <= lay.smem <= amg_cuda.TAIL_SMEM_BYTES
    K, C = len(sizes), plan.cluster
    order = list(range(K - 1, C - 1, -1)) + list(range(C - 1, -1, -1))
    staged = [lay.stage[k] for k in order]
    assert staged == sorted(staged, reverse=True)       # a prefix of the coarsest-first order
    assert lay.stage[-1] == (sizes != [9_000])
    if not all(lay.stage):
        k = order[staged.index(False)]
        assert lay.smem + amg_tail.layout(plan, elem, False, 10**9, 512).smem \
            - amg_tail.layout(plan, elem, False, 10**9, 512).vectors > amg_cuda.TAIL_SMEM_BYTES
        assert lay.st[k] == -1


@pytest.mark.parametrize("elem, want", [(4, 5), (8, 6)])
def test_tail_split_starts_where_every_level_stages(elem, want):
    """A V-cycle's tail starts at tail_start's level at TAIL_ROWS (the
    TJunction's 7,750 rows, 7 terms a row) where that tail stages every
    level (float32), and a level lower where it cannot (float64: 247,120 B
    to stage): the tail it launches never reads a level from global
    memory."""
    rows, aggs, prolong = _synthetic(TJ_SIZES, 7)
    assert amg.tail_start(TJ_SIZES, amg_cuda.TAIL_ROWS) == 5
    t = amg_cuda.tail_split(rows, aggs, prolong, elem)
    assert t == want
    lay = amg_cuda.tail_layout(amg_tail.tail_plan(rows[t:], aggs[t:], prolong[t:],
                                                  amg_cuda.TAIL_BLOCK0_ROWS), elem)
    assert all(lay.stage)


def test_amg_tail_raises_elsewhere(polys):
    """Meta tensors: a ValueError and no launch counted; mismatched
    level lists: a ValueError naming the counts."""
    rows, aggs, ops, prolong, r = _hierarchy(polys["duct"], "duct", torch.float64, 9)
    before = amg_cuda.amg_tail.launches
    meta_ops = [(d.to("meta"), o.to("meta")) for d, o in ops]
    with pytest.raises(ValueError):
        amg_cuda.amg_tail(rows, aggs, meta_ops, prolong, r.to("meta"))
    with pytest.raises(ValueError, match="takes"):
        amg_cuda.amg_tail(rows, aggs[:-1], ops, prolong, r)
    with pytest.raises(ValueError, match="restriction of level 0"):
        amg_cuda.amg_tail(rows[:2], aggs[1:2], ops[:2], prolong[:1], r)
    assert amg_cuda.amg_tail.launches == before


@pytest.fixture(scope="module")
def duct_pair(polys, tmp_path_factory):
    """The duct's FV tables and hierarchy in both packages from one host
    payload, a pressure-like matrix, and its right-hand side."""
    import jax.numpy as jnp

    path = os.path.join(make_flow_case(tmp_path_factory.mktemp("tail_jax"), "duct"), "system",
                        "blockMeshDict")
    jm = jfv.fv_mesh(jblockmesh.generate(path), dtype=jnp.float64)
    jh = jfv.build_amg(jm, min_coarse=20)
    m, h = convert.to_fv_mesh(jm, device=CPU), convert.to_amg(jh, device=CPU)
    rng = np.random.default_rng(10)
    off = -torch.as_tensor(rng.uniform(0.5, 2.0, m.n_internal), dtype=torch.float64)
    diag = fv.index_sum(m.n_cells, [(m.own_i, -off), (m.neighbour, -off)],
                        out=torch.as_tensor(rng.uniform(0.1, 1.0, m.n_cells)))
    A = fv.FvMatrix(diag=diag, lower=off, upper=off,
                    source=torch.zeros(m.n_cells, 1, dtype=torch.float64))
    b = torch.as_tensor(rng.standard_normal(m.n_cells))
    jA = jfv.FvMatrix(diag=jnp.asarray(diag.numpy()), lower=jnp.asarray(off.numpy()),
                      upper=jnp.asarray(off.numpy()), source=jnp.asarray(A.source.numpy()))
    return m, h, A, b, jm, jh, jA, jnp.asarray(b.numpy())


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("tail_rows", [0, amg_cuda.TAIL_ROWS, 100])
def test_vcycle_through_the_tail_matches_jax(duct_pair, monkeypatch, tail_rows):
    """float64, the card's path (the kernels' plain versions) with the
    tail from the coarsest alone, the whole hierarchy, or a split between:
    one V-cycle and a whole AMG-CG solve within 1e-12 of JAX's, the same
    CG count."""
    monkeypatch.setattr(fv, "_FIXED_ORDER_ON_CPU", True)
    monkeypatch.setattr(amg_cuda, "TAIL_ROWS", tail_rows)
    m, h, A, b, jm, jh, jA, jb = duct_pair
    sizes = [m.n_cells] + list(h.sizes)
    assert 0 < amg.tail_start(sizes, 100) < len(h.sizes)    # a real split
    levels, jlevels = fv.amg_coarse_ops(m, h, A), jfv.amg_coarse_ops(jm, jh, jA)
    assert _rel(fv.amg_vcycle(m, h, A, levels, b), jfv.amg_vcycle(jm, jh, jA, jlevels, jb)) \
        <= JAX_TOL
    x, res, it = fv.amg_cg_solve(m, h, A, b, torch.zeros_like(b), tol=1e-10, max_iter=200)
    jx, jres, jit = jfv.amg_cg_solve(jm, jh, jA, jb, 0.0 * jb, tol=1e-10, max_iter=200)
    assert it == int(jit) and 3 < it < 200
    assert _rel(x, jx) <= JAX_TOL
    assert float(res) <= 1e-10
