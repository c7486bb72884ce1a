"""PyTorch port: ``fv.index_sum``, the face-to-cell sums of every flow
operator.  The card's path (a gather in a fixed order and a segment sum per
row) runs here on the CPU with ``fv._FIXED_ORDER_ON_CPU`` set, against the
CPU's ``index_add_`` path on the same float64 inputs, and against itself
bit for bit; then whole flow steps, single-device and sharded, on both
paths."""

from torch_port_common import CPU, flowshard_meshes

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.models import fv, pimple  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard  # noqa: E402

F64 = torch.float64


def _case(name, rng):
    """(n_out, parts, out, drop) of one case, from ``rng``."""
    n_out = 50
    if name == "heavy_row":     # a shard mesh's dummy cell takes every padded face
        idx = rng.integers(0, n_out, 400)
        idx[:300] = n_out - 1
        return n_out, [(idx, rng.standard_normal(400))], None, False
    if name == "two_parts_vector":
        return n_out, [(rng.integers(0, n_out, 120), rng.standard_normal((120, 3))),
                       (rng.integers(0, n_out, 80), rng.standard_normal((80, 3)))], None, False
    if name == "onto_out":
        return (n_out, [(rng.integers(0, n_out, 120), rng.standard_normal(120))],
                rng.standard_normal(n_out), False)
    if name == "drop":
        return n_out, [(rng.integers(-3, n_out + 3, 200), rng.standard_normal(200))], None, True
    if name == "drop_onto_out":
        return (n_out, [(rng.integers(-3, n_out + 3, 200), rng.standard_normal(200))],
                rng.standard_normal(n_out), True)
    return n_out, [(rng.integers(0, n_out, 120), rng.standard_normal(120))], None, False


@pytest.mark.parametrize("name", ["one_part", "two_parts_vector", "heavy_row", "onto_out",
                                  "drop", "drop_onto_out"])
def test_index_sum_fixed_order_matches_index_add(monkeypatch, name):
    rng = np.random.default_rng(7)
    n_out, parts, out, drop = _case(name, rng)
    parts = [(torch.as_tensor(i, dtype=torch.int64), torch.as_tensor(v, dtype=F64))
             for i, v in parts]
    out = None if out is None else torch.as_tensor(out, dtype=F64)
    out0 = None if out is None else out.clone()
    want = fv.index_sum(n_out, parts, out=out, drop=drop)
    # by hand, in float64 on the host
    ref = np.zeros((n_out,) + tuple(parts[0][1].shape[1:])) if out is None else out.numpy().copy()
    for i, v in parts:
        i, v = i.numpy(), v.numpy()
        keep = (i >= 0) & (i < n_out)
        np.add.at(ref, i[keep], v[keep])
    monkeypatch.setattr(fv, "_FIXED_ORDER_ON_CPU", True)
    got = fv.index_sum(n_out, parts, out=out, drop=drop)
    again = fv.index_sum(n_out, parts, out=out, drop=drop)
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(want.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    assert torch.equal(got, again)
    if out is not None:
        assert torch.equal(out, out0)       # out itself is left as it is


def test_index_sum_plan_follows_its_index(monkeypatch):
    """The plan is found again for the same index tensor and views of it,
    and made anew after the index changes in place."""
    monkeypatch.setattr(fv, "_FIXED_ORDER_ON_CPU", True)
    idx = torch.tensor([0, 2, 2, 1, 0], dtype=torch.int64)
    v = torch.arange(5, dtype=F64)
    plan = fv._sum_plan(3, [idx])
    assert fv._sum_plan(3, [idx]) is plan
    assert fv._sum_plan(3, [idx[:5]]) is plan
    assert fv.index_sum(3, [(idx, v)]).tolist() == [4.0, 3.0, 3.0]
    idx[4] = 1
    assert fv._sum_plan(3, [idx]) is not plan
    assert fv.index_sum(3, [(idx, v)]).tolist() == [0.0, 7.0, 3.0]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return flowshard_meshes(tmp_path_factory.mktemp("sums"))


def _duct(pm):
    from cudaparticlesfoam_tpu_torch.models.simple import FlowState

    m = fv.fv_mesh(pm, dtype=F64, device=CPU)
    wall = ("noSlip", 0.0)
    u_bcs = fv.make_bcs(m, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]), "walls": wall,
                            "frontAndBack": ("empty", 0.0)}, 3)
    p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=F64).repeat(m.n_cells, 1)
    return m, u_bcs, p_bcs, FlowState(u=u0, p=torch.zeros(m.n_cells, dtype=F64),
                                      flux=fv.flux_of(m, u0, u_bcs))


@pytest.mark.parametrize("solver", ["single_amg", "sharded_4", "sharded_4_local_amg"])
def test_flow_step_on_the_cards_sums(monkeypatch, meshes, solver):
    """Two linearUpwind PIMPLE steps on the duct (AMG-CG single-device, or 4
    slabs with Jacobi-CG or local AMG-CG) give the same fields, within
    1e-10, and the same CG counts on both paths of ``index_sum``."""
    pm = meshes["duct"][0]
    cfg = pimple.PimpleConfig(nu=1e-3, n_outer=1, n_correctors=2, n_jacobi=8, p_tol=1e-12,
                              p_max_iter=600, div_scheme="linearUpwind", p_solver="amg")
    res = []
    for fixed in (False, True):
        monkeypatch.setattr(fv, "_FIXED_ORDER_ON_CPU", fixed)
        m, u_bcs, p_bcs, st = _duct(pm)
        its = []
        if solver == "single_amg":
            amg = fv.build_amg(m)
            for _ in range(2):
                st, diag = pimple.pimple_step(m, st, u_bcs, p_bcs, cfg, 0.02, amg=amg)
                its += diag["p_iters"]
            u, p = st.u.numpy(), st.p.numpy()
        else:
            smesh, bglob = flowshard.decompose(pm, 4, dtype=F64, device=CPU)
            ub, pb = (flowshard.shard_bcs(b, bglob, smesh) for b in (u_bcs, p_bcs))
            us, ps = flowshard.scatter_cells(smesh, st.u), flowshard.scatter_cells(smesh, st.p)
            flux = flowshard.flux_init(smesh, us, ub)
            lamg = flowshard.build_local_amg(smesh) if solver.endswith("amg") else None
            step = flowshard.make_sharded_pimple(smesh, cfg, lamg=lamg)
            extra = () if lamg is None else (lamg,)
            for _ in range(2):
                us, ps, flux, diag = step(smesh, us, ps, flux, ub, pb, 0.02, *extra)
                its += diag["p_iters"]
            u = flowshard.gather_cells(smesh, us).numpy()
            p = flowshard.gather_cells(smesh, ps).numpy()
        res.append((u, p, its))
    (u0, p0, i0), (u1, p1, i1) = res
    assert i0 == i1
    assert np.abs(u1 - u0).max() <= 1e-10 * np.abs(u0).max()
    assert np.abs(p1 - p0).max() <= 1e-10 * np.abs(p0).max()
