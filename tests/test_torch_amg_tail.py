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

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh  # noqa: E402
from cudaparticlesfoam_tpu.models import fv as jfv  # noqa: E402
from cudaparticlesfoam_tpu_torch import convert  # noqa: E402
from cudaparticlesfoam_tpu_torch.io import blockmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv  # noqa: E402
from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda  # noqa: E402
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
    TJunction (2,080 cells) and pitzDaily (12,225 cells)."""
    assert "duct" in FLOW_CASES
    duct = make_flow_case(tmp_path_factory.mktemp("tail"), "duct")
    tj = shrink_tjunction(tmp_path_factory.mktemp("tail_tj"))
    out = {name: blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
           for name, case in (("duct", duct), ("tjunction", tj))}
    out["pitzDaily"] = blockmesh.generate(PITZ_BMD)
    return out


MIN_COARSE = {"duct": 20, "tjunction": 200, "pitzDaily": 200}


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


def test_descriptor_matches_the_kernel_struct():
    """``csrc/amg.cu``'s TailLevel and TailParams field for field: nine
    pointers then six int32 a level (96 B); two pointers, omega, eight
    int32, then 16 levels (1,592 B, under the 4 KB of kernel parameters)."""
    assert [f[0] for f in amg_cuda.TailLevel._fields_] == [
        "off", "pos", "col", "diag", "offc", "aoff", "acell", "agg", "valid",
        "n", "nf", "shift", "r_at", "x_at", "pad"]
    assert [f[0] for f in amg_cuda.TailParams._fields_] == [
        "r_top", "x_out", "omega", "levels", "sweeps", "xb_at", "stage", "st_diag",
        "st_coef", "st_col", "st_off", "lv"]
    assert ctypes.sizeof(amg_cuda.TailLevel) == 96
    assert amg_cuda.TailParams.lv.offset == 56
    assert ctypes.sizeof(amg_cuda.TailParams) == 56 + 16 * 96 < 4096
    with open(os.path.join(os.path.dirname(amg.__file__), "..", "csrc", "amg.cu")) as fh:
        src = fh.read()
    assert "constexpr int TAIL_MAX_LEVELS = 16;" in src and amg.MAX_TAIL_LEVELS == 16
    assert f"constexpr int TAIL_SMEM_MAX = {amg_cuda.TAIL_SMEM_BYTES};" in src
    assert f"constexpr int TAIL_THREADS = {amg_cuda.TAIL_THREADS};" in src
    assert f"constexpr int TAIL_BLOCKS = {amg_cuda.TAIL_BLOCKS};" in src


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
    r, x = torch.ones(40), torch.empty(40)
    lay = amg_cuda.tail_layout([40] * 4, 78, 4)
    p = amg_cuda.tail_params(rows, aggs, ops, prolong, r, x, lay)
    assert p.levels == 4 and p.sweeps == amg.COARSEST_SWEEPS and p.omega == amg.OMEGA
    assert p.stage == 1 and (p.st_diag, p.st_coef, p.st_col, p.st_off) == lay.st
    assert (p.r_top, p.x_out) == (r.data_ptr(), x.data_ptr())
    for k in range(4):
        lv = p.lv[k]
        assert (lv.off, lv.n, lv.nf, lv.shift) == (rows[k].offsets.data_ptr(), 40, 39,
                                                  lay.shifts[k])
        assert (lv.diag, lv.offc) == (ops[k][0].data_ptr(), ops[k][1].data_ptr())
        assert (lv.aoff is None) == (k == 3) and lv.valid is None
    assert p.lv[4].off is None and p.lv[4].n == 0
    many = _chain(17)
    args = ([q for q, _ in many], [amg.agg_plan(40, a) for _, a in many[:-1]],
            [(torch.ones(40), torch.full((39,), -0.1))] * 17, [(a, None) for _, a in many[:-1]])
    with pytest.raises(ValueError, match="1 to 16 levels"):
        amg_cuda.tail_params(*args, r, x, lay)
    with pytest.raises(ValueError, match="1 to 16 levels"):
        amg_cuda.amg_tail(*args, r)
    with pytest.raises(ValueError, match="1 to 16 levels"):
        amg_cuda.tail_layout([40] * 17, 78, 4)


@pytest.mark.parametrize("sizes, elem", [(PITZ_SIZES, 8), (TJ_SIZES[4:], 8), (BOX_SIZES[2:], 8),
                                         (PITZ_SIZES, 4), ([116], 8), ([3, 2, 1], 4)])
def test_layout_places_every_vector_apart(sizes, elem):
    """Each level's rows fit its blocks (16 of them, the coarsest all in
    block 0), r and x of the levels below the top, the coarsest's two
    sweep buffers and its staged plan do not overlap, and the tails of the
    pitzDaily, the TJunction and the box fit in a block's shared memory."""
    nnz = 6 * sizes[-1]
    lay = amg_cuda.tail_layout(sizes, nnz, elem)
    assert lay.stage
    K = len(sizes)
    spans = []
    for k, (n, s) in enumerate(zip(sizes, lay.shifts)):
        if k == K - 1:
            assert s == 31
        else:
            # the least power of two that spreads the rows over 16 blocks
            assert (n - 1) >> s < amg_cuda.TAIL_BLOCKS
            assert s == 0 or 1 << (s - 1) < -(-n // amg_cuda.TAIL_BLOCKS)
        cap = n if k == K - 1 else 1 << s
        if k > 0:
            spans += [(lay.r_at[k], cap), (lay.x_at[k], cap)]
    if K == 1:
        spans.append((lay.x_at[0], sizes[0]))
    spans.append((lay.xb_at, sizes[-1]))
    spans = [(a * elem, n * elem) for a, n in spans]
    n = sizes[-1]
    if lay.stage:
        spans += [(lay.st[0], n * elem), (lay.st[1], nnz * elem), (lay.st[2], 4 * nnz),
                  (lay.st[3], 4 * (n + 1))]
        assert lay.elements * elem == lay.st[0]
        assert all(a % 4 == 0 for a in lay.st) and lay.st[1] % elem == 0
    else:
        assert lay.st == (0, 0, 0, 0)
    spans.sort()
    assert spans[0][0] == 0 and all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert lay.smem == spans[-1][0] + spans[-1][1] <= amg_cuda.TAIL_SMEM_BYTES
    assert 32 <= lay.threads <= amg_cuda.TAIL_THREADS and lay.threads % 32 == 0


@pytest.mark.parametrize("sizes, nnz, elem, fits", [
    (TJ_SIZES, 744, 8, False),        # the whole TJunction hierarchy in float64: 264,864 B
    (TJ_SIZES, 744, 4, True),         # in float32: 132,432 B
    (TJ_SIZES[1:], 744, 8, True),
    ([40_000], 240_000, 8, False),    # a coarsest of 40,000 rows: x, its second buffer
    ([9_000], 54_000, 8, True),       # 9,000 rows fit, but not the staged plan beside them
])
def test_layout_raises_with_the_numbers_where_shared_memory_is_short(sizes, nnz, elem, fits):
    """Where a tail's vectors do not fit in a block's shared memory the
    layout raises and names the bytes; the coarsest's plan is staged only
    where it fits beside them."""
    if not fits:
        with pytest.raises(ValueError, match=f"more than its {amg_cuda.TAIL_SMEM_BYTES} B"):
            amg_cuda.tail_layout(sizes, nnz, elem)
        return
    lay = amg_cuda.tail_layout(sizes, nnz, elem)
    assert lay.elements * elem <= amg_cuda.TAIL_SMEM_BYTES
    assert lay.stage == (lay.smem > lay.elements * elem)
    if not lay.stage:
        assert lay.smem == lay.elements * elem and lay.st == (0, 0, 0, 0)


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
