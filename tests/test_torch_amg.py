"""PyTorch port: the AMG-CG pressure solve's kernels (``csrc/amg.cu``) through
their plain versions on the CPU (``ops/amg.py``, reached through the
wrappers of ``ops/amg_cuda.py`` on CPU tensors).

Each plain version equals the card's fixed-order path as it was before the
kernels (``fv.index_sum`` with ``fv._FIXED_ORDER_ON_CPU`` set: terms in plan
order, a row summed from 0 left to right) bit for bit, in float32 and
float64, at every level of the 3-D duct's and the shrunk TJunction's
hierarchies, for [nc] and [nc, 3] matvecs, and for the sharded
``_local_vcycle`` with its masks.  A V-cycle and ``amg_cg_solve`` match the
JAX package's on the duct in float64 within 1e-12 with equal CG counts,
on both paths.  Each wrapper runs the plain version for CPU tensors and
raises for any other device it cannot launch on; it never falls back."""

from torch_port_common import CPU, FLOW_CASES, make_flow_case, shrink_tjunction

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
OMEGA = amg.OMEGA


@pytest.fixture(scope="module")
def polys(tmp_path_factory):
    """{name: (port PolyMesh, blockMeshDict path)} of the duct of
    FLOW_CASES and the shrunk TJunction (2,080 cells)."""
    assert "duct" in FLOW_CASES
    duct = make_flow_case(tmp_path_factory.mktemp("amg"), "duct")
    tj = shrink_tjunction(tmp_path_factory.mktemp("amg_tj"))
    out = {}
    for name, case in (("duct", duct), ("tjunction", tj)):
        path = os.path.join(case, "system", "blockMeshDict")
        out[name] = (blockmesh.generate(path), path)
    return out


def _system(m, seed):
    """A symmetric, diagonally dominant Laplacian-like matrix on ``m`` (the
    pressure matrix's shape: off < 0 on the faces, diag their negated sum
    and more), level 0's lower and upper apart, and a right-hand side."""
    rng = np.random.default_rng(seed)
    dt, nf, nc = m.dtype, m.n_internal, m.n_cells
    off = -torch.as_tensor(rng.uniform(0.5, 2.0, nf), dtype=dt)
    diag = torch.as_tensor(rng.uniform(0.1, 1.0, nc), dtype=dt)
    diag = fv.index_sum(nc, [(m.own_i, -off), (m.neighbour, -off)], out=diag)
    lower = off * torch.as_tensor(rng.uniform(0.9, 1.1, nf), dtype=dt)
    A = fv.FvMatrix(diag=diag, lower=off, upper=off, source=torch.zeros(nc, 1, dtype=dt))
    return A, lower, torch.as_tensor(rng.standard_normal(nc), dtype=dt), rng


def _fixed_sym_matvec(diag, off, own, nei, x):
    return fv.index_sum(diag.shape[0], [(own, off * x[nei]), (nei, off * x[own])],
                        out=diag * x)


def _fixed_vcycle(m, h, A, levels, r):
    """``fv.amg_vcycle`` as it was before the kernels (its descent over
    ``fv.index_sum``), run with the fixed order."""
    def descend(li, r):
        if li == 0:
            diag, off, own, nei = A.diag, A.upper, m.own_i, m.neighbour
        else:
            diag, off = levels[li - 1]
            own, nei = h.owners[li - 1], h.neighs[li - 1]
        x = OMEGA * r / diag
        if li == len(h.sizes):
            for _ in range(12):
                x = x + OMEGA * (r - _fixed_sym_matvec(diag, off, own, nei, x)) / diag
            return x
        r1 = r - _fixed_sym_matvec(diag, off, own, nei, x)
        xc = descend(li + 1, fv.index_sum(h.sizes[li], [(h.aggs[li], r1)]))
        x = x + xc[h.aggs[li]]
        x = x + OMEGA * (r - _fixed_sym_matvec(diag, off, own, nei, x)) / diag
        return x

    return descend(0, r)


def _levels_of(m, h, A):
    """[(n, own, nei, diag, off, agg or None)] of level 0 .. L."""
    out = [(m.n_cells, m.own_i, m.neighbour, A.diag, A.upper)]
    for li, (d_, o_) in enumerate(fv.amg_coarse_ops(m, h, A)):
        out.append((h.sizes[li], h.owners[li], h.neighs[li], d_, o_))
    return [lv + ((h.aggs[li] if li < len(h.sizes) else None),) for li, lv in enumerate(out)]


@pytest.fixture
def fixed(monkeypatch):
    monkeypatch.setattr(fv, "_FIXED_ORDER_ON_CPU", True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["duct", "tjunction"])
def test_plain_matvec_equals_fixed_order_path(polys, fixed, name, dtype):
    """``fv_matvec``'s plain version = ``fv.index_sum``'s fixed order, at
    level 0 (lower and upper apart) and every coarse level (symmetric),
    for x [nc] and [nc, 3]."""
    m = fv.fv_mesh(polys[name][0], dtype=DTYPES[dtype], device=CPU)
    h = fv.build_amg(m, min_coarse=20 if name == "duct" else 200)
    A, lower, _, rng = _system(m, 1)
    assert len(h.sizes) >= 2
    for li, (n, own, nei, diag, off, _) in enumerate(_levels_of(m, h, A)):
        up, lo = (off, lower) if li == 0 else (off, off)
        plan = amg.row_plan(n, own, nei)
        for shape in ((n,), (n, 3)):
            x = torch.as_tensor(rng.standard_normal(shape), dtype=m.dtype)
            ex = (lambda c: c) if len(shape) == 1 else (lambda c: c[:, None])
            want = fv.index_sum(n, [(own, ex(up) * x[nei]), (nei, ex(lo) * x[own])],
                                out=ex(diag) * x)
            got = amg_cuda.fv_matvec(plan, diag, up, lo, x)
            assert torch.equal(got, want), (li, shape)
        if li == 0:
            A0 = fv.FvMatrix(diag=diag, lower=lo, upper=up, source=A.source)
            assert torch.equal(fv.matvec(m, A0, x), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["duct", "tjunction"])
def test_plain_levels_equal_fixed_order_vcycle(polys, fixed, name, dtype):
    """``amg_down`` / ``amg_up`` / ``amg_tail`` (one level)'s plain versions = the
    V-cycle's expressions over ``fv.index_sum``'s fixed order at every
    level, and ``fv.amg_vcycle`` = the V-cycle as it was, bit for bit."""
    m = fv.fv_mesh(polys[name][0], dtype=DTYPES[dtype], device=CPU)
    h = fv.build_amg(m, min_coarse=20 if name == "duct" else 200)
    A, _, r, rng = _system(m, 2)
    lv = _levels_of(m, h, A)
    for li, (n, own, nei, diag, off, agg) in enumerate(lv):
        rows = amg.row_plan(n, own, nei)
        rl = torch.as_tensor(rng.standard_normal(n), dtype=m.dtype)
        if agg is None:      # the coarsest level
            x = OMEGA * rl / diag
            for _ in range(12):
                x = x + OMEGA * (rl - _fixed_sym_matvec(diag, off, own, nei, x)) / diag
            assert torch.equal(amg_cuda.amg_tail([rows], [], [(diag, off)], [], rl), x), li
            continue
        nc = lv[li + 1][0]
        r1 = rl - _fixed_sym_matvec(diag, off, own, nei, OMEGA * rl / diag)
        want = fv.index_sum(nc, [(agg, r1)])
        assert torch.equal(amg_cuda.amg_down(rows, amg.agg_plan(nc, agg), diag, off, rl),
                           want), li
        xc = torch.as_tensor(rng.standard_normal(nc), dtype=m.dtype)
        x = OMEGA * rl / diag + xc[agg]
        want = x + OMEGA * (rl - _fixed_sym_matvec(diag, off, own, nei, x)) / diag
        assert torch.equal(amg_cuda.amg_up(rows, diag, off, rl, agg, xc), want), li
    levels = fv.amg_coarse_ops(m, h, A)
    assert torch.equal(fv.amg_vcycle(m, h, A, levels, r), _fixed_vcycle(m, h, A, levels, r))


def _fixed_local_vcycle(lamg, s, m, diag0, off0, levels, r0):
    """``flowshard._local_vcycle`` as it was before the kernels."""
    t = lamg.shard[s]
    L = lamg.n_levels

    def matvec_l(li, x):
        if li == 0:
            return _fixed_sym_matvec(diag0, off0, m.own_i, m.neighbour, x)
        d_, o_ = levels[li - 1]
        return _fixed_sym_matvec(d_, o_, t["owners"][li - 1], t["neighs"][li - 1], x)

    def descend(li, r):
        d_ = diag0 if li == 0 else levels[li - 1][0]
        x = OMEGA * r / d_
        if li == L:
            for _ in range(12):
                x = x + OMEGA * (r - matvec_l(li, x)) / d_
            return x
        r1 = r - matvec_l(li, x)
        xc = descend(li + 1, fv.index_sum(lamg.sizes[li][0], [(t["aggs"][li], r1)],
                                          drop=True))
        x = x + xc[t["aggs_c"][li]] * t["agg_valid"][li]
        x = x + OMEGA * (r - matvec_l(li, x)) / d_
        return x

    return descend(0, r0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_local_vcycle_equals_fixed_order(polys, fixed, dtype):
    """The 4-shard duct's local V-cycles (masked level-0 operator, padded
    levels, dropped ghosts, the clipped prolongation times ``agg_valid``)
    through the level kernels' plain versions = as they were, bit for
    bit, shard by shard."""
    pm = polys["duct"][0]
    smesh, _ = flowshard.decompose(pm, 4, dtype=DTYPES[dtype], device=CPU)
    lamg = flowshard.build_local_amg(smesh, min_coarse=5)
    assert lamg.n_levels >= 2
    rng = np.random.default_rng(3)
    for s, sh in enumerate(smesh.shards):
        m, dt = sh.m, sh.m.dtype
        off0 = (-torch.as_tensor(rng.uniform(0.5, 2.0, m.n_internal), dtype=dt)
                * lamg.shard[s]["off_mask"])
        diag0 = fv.index_sum(m.n_cells, [(m.own_i, -off0), (m.neighbour, -off0)],
                             out=torch.as_tensor(rng.uniform(0.1, 1.0, m.n_cells), dtype=dt))
        diag0 = torch.where(sh.mask, diag0, 1.0)
        levels = flowshard._local_coarse_ops(lamg, s, m, diag0, off0)
        r0 = torch.where(sh.mask, torch.as_tensor(rng.standard_normal(m.n_cells), dtype=dt), 0.0)
        got = flowshard._local_vcycle(lamg, s, m, diag0, off0, levels, r0)
        assert torch.equal(got, _fixed_local_vcycle(lamg, s, m, diag0, off0, levels, r0)), s


@pytest.fixture(scope="module")
def duct_pair(polys):
    """The duct's FV tables and a 3-level hierarchy (min_coarse 20) in both
    packages from one host payload: JAX's, carried to the port."""
    import jax.numpy as jnp

    jm = jfv.fv_mesh(jblockmesh.generate(polys["duct"][1]), dtype=jnp.float64)
    jh = jfv.build_amg(jm, min_coarse=20)
    m, h = convert.to_fv_mesh(jm, device=CPU), convert.to_amg(jh, device=CPU)
    assert len(h.sizes) >= 2
    A, _, b, _ = _system(m, 4)
    jA = jfv.FvMatrix(diag=jnp.asarray(A.diag.numpy()), lower=jnp.asarray(A.lower.numpy()),
                      upper=jnp.asarray(A.upper.numpy()), source=jnp.asarray(A.source.numpy()))
    return m, h, A, b, jm, jh, jA, jnp.asarray(b.numpy())


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("path", ["cpu", "fixed"])
def test_vcycle_and_amg_cg_match_jax(duct_pair, monkeypatch, path):
    """float64, the same host payload: one V-cycle and a whole AMG-CG
    solve within 1e-12 of JAX's, the same CG count, on the CPU's path and
    on the card's (the kernels' plain versions)."""
    monkeypatch.setattr(fv, "_FIXED_ORDER_ON_CPU", path == "fixed")
    m, h, A, b, jm, jh, jA, jb = duct_pair
    levels, jlevels = fv.amg_coarse_ops(m, h, A), jfv.amg_coarse_ops(jm, jh, jA)
    assert _rel(fv.amg_vcycle(m, h, A, levels, b), jfv.amg_vcycle(jm, jh, jA, jlevels, jb)) \
        <= JAX_TOL
    x, res, it = fv.amg_cg_solve(m, h, A, b, torch.zeros_like(b), tol=1e-10, max_iter=200)
    jx, jres, jit = jfv.amg_cg_solve(jm, jh, jA, jb, 0.0 * jb, tol=1e-10, max_iter=200)
    assert it == int(jit) and 3 < it < 200
    assert _rel(x, jx) <= JAX_TOL
    assert float(res) <= 1e-10


def _wrapper_calls(plan, aggs, t):
    """Each wrapper's call on the tensors ``t`` (a dict on one device)."""
    return {
        "fv_matvec": lambda: amg_cuda.fv_matvec(plan, t["d"], t["o"], t["o"], t["x"]),
        "amg_down": lambda: amg_cuda.amg_down(plan, aggs, t["d"], t["o"], t["x"]),
        "amg_up": lambda: amg_cuda.amg_up(plan, t["d"], t["o"], t["x"], t["agg"], t["xc"]),
        "amg_tail": lambda: amg_cuda.amg_tail([plan], [], [(t["d"], t["o"])], [], t["x"]),
        # the coarsest level alone: a tail of one level, here with 3 sweeps
        "amg_coarsest": lambda: amg_cuda.amg_tail([plan], [], [(t["d"], t["o"])], [], t["x"],
                                                  sweeps=3),
    }


@pytest.mark.parametrize("name", [f.__name__ for f in amg_cuda.WRAPPERS] + ["amg_coarsest"])
def test_wrappers_run_the_plain_version_on_the_cpu_and_raise_elsewhere(polys, name):
    """CPU tensors: the plain version, no launch counted.  Meta tensors (a
    device with no kernel): a ValueError, with the plans on the CPU or on
    the meta device alike, and no fall-back to the plain version.
    ``amg_coarsest`` is the tail of the coarsest level alone with 3 sweeps
    (``amg_tail`` of one level): its launches count in ``amg_tail``'s."""
    m = fv.fv_mesh(polys["duct"][0], dtype=torch.float64, device=CPU)
    h = fv.build_amg(m, min_coarse=20)
    A, _, x, rng = _system(m, 5)
    nc = h.sizes[0]
    t = {"d": A.diag, "o": A.upper, "x": x, "agg": h.aggs[0],
         "xc": torch.as_tensor(rng.standard_normal(nc), dtype=m.dtype)}
    plan, aggs = amg.row_plan(m.n_cells, m.own_i, m.neighbour), amg.agg_plan(nc, h.aggs[0])
    plain = {
        "fv_matvec": lambda: amg.matvec_plain(plan, A.diag, A.upper, A.upper, x),
        "amg_down": lambda: amg.down_plain(plan, aggs, A.diag, A.upper, x),
        "amg_up": lambda: amg.up_plain(plan, A.diag, A.upper, x, h.aggs[0], t["xc"]),
        "amg_tail": lambda: amg.coarsest_plain(plan, A.diag, A.upper, x),
        "amg_coarsest": lambda: amg.coarsest_plain(plan, A.diag, A.upper, x, sweeps=3),
    }[name]
    wrapper = amg_cuda.amg_tail if name == "amg_coarsest" else getattr(amg_cuda, name)
    before = wrapper.launches
    assert torch.equal(_wrapper_calls(plan, aggs, t)[name](), plain())
    assert wrapper.launches == before
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError):
        _wrapper_calls(plan, aggs, meta)[name]()
    meta_plan = amg.RowPlan(**{**vars(plan), "offsets": plan.offsets.to("meta"),
                               "_columns": None})
    meta_aggs = amg.RowPlan(**{**vars(aggs), "offsets": aggs.offsets.to("meta"),
                               "_columns": None})
    with pytest.raises(ValueError, match="no AMG kernel"):
        _wrapper_calls(meta_plan, meta_aggs, meta)[name]()
    assert wrapper.launches == before


def test_row_plan_follows_its_indices():
    """A row plan is found again for the same index tensors and views of
    them, made anew after an index changes in place; its rows list each
    face's other cell in owner-part-then-neighbour-part order, and leave
    out a face whose two cells are one."""
    own = torch.tensor([0, 0, 1, 2], dtype=torch.int64)
    nei = torch.tensor([1, 2, 2, 3], dtype=torch.int64)
    plan = amg.row_plan(4, own, nei)
    assert amg.row_plan(4, own[:4], nei) is plan
    assert plan.h_offsets.tolist() == [0, 2, 4, 7, 8]
    assert plan.h_pos.tolist() == [0, 1, 2, 4, 3, 5, 6, 7]
    assert plan.h_col.tolist() == [1, 2, 2, 0, 3, 0, 1, 2]
    assert plan.max_len == 3 and plan.n_src == 4
    nei[3] = 0
    again = amg.row_plan(4, own, nei)
    assert again is not plan and again.h_offsets.tolist() == [0, 3, 5, 8, 8]
    # a face from a cell to itself (a shard mesh's padding) is in no row
    pad = amg.row_plan(3, torch.tensor([0, 2, 2]), torch.tensor([1, 2, 2]))
    assert pad.h_offsets.tolist() == [0, 1, 2, 2] and pad.h_col.tolist() == [1, 0]
    agg = torch.tensor([1, 0, 1, 5], dtype=torch.int64)
    ap = amg.agg_plan(2, agg)
    assert ap.h_offsets.tolist() == [0, 1, 3] and ap.h_col.tolist() == [1, 0, 2]
