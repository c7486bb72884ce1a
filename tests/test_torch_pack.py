"""PyTorch port: the per-call pack and unpack of ``run_cycles``
(``ops/fused_cuda.pack_rows`` / ``unpack_rows``, ``csrc/pack.cu``).

On the CPU the plain versions run: for the three layouts the port packs
(TetVelocity [n, 32] with 20-column rows, VertexVelocity [n, 40] with the
padded 32-column rows, convex [n, 32] with 24-column rows) and both
dtypes, with a ragged n and negative tets, the mega is the JAX package's
``pack_state`` bit for bit, and the unpack is its ``unpack_state``;
unpacking and packing again gives the same mega bit for bit;
``PackedRun.result`` returns fresh tensors; ``PackedRun.set_mesh`` packs
what a new call would; and the kernels' launch counters do not move.

On the card (marker ``card``, skipped without one): each kernel equals its
plain version bit for bit at 65,536 and 65,499 lanes, with negative tets
and pos views; one ``run_cycles`` call launches each kernel once and runs
no torch gather or copy kernel."""

from torch_port_common import CPU

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cudaparticlesfoam_tpu.mesh as jmesh  # noqa: E402
from cudaparticlesfoam_tpu.ops import fused as jfused  # noqa: E402
from cudaparticlesfoam_tpu.ops import fused_convex as jfused_convex  # noqa: E402
import cudaparticlesfoam_tpu_torch as cpt  # noqa: E402
from cudaparticlesfoam_tpu_torch import convert  # noqa: E402
from cudaparticlesfoam_tpu_torch import mesh as tmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.ops import fused, fused_convex, fused_cuda  # noqa: E402
from cudaparticlesfoam_tpu_torch.stepper import PackedRun  # noqa: E402
from cudaparticlesfoam_tpu_torch.utils.profiling import RECORDER  # noqa: E402

LAYOUTS = ("tet", "pk", "convex")
DTYPES = (torch.float32, torch.float64)


def _mesh(nside, dtype, device):
    return cpt.with_convex_rows(cpt.with_pk_rows(
        cpt.box_mesh(nside, nside, nside, dtype=dtype, device=device)))


def _table(mesh, layout):
    """(row table, mega width) of a layout."""
    if layout == "convex":
        return fused_convex.cx_table(mesh), fused_convex.WIDTH
    ly = fused.LAYOUT_PK if layout == "pk" else fused.LAYOUT_TET
    return fused.row_table(mesh, ly), ly.width


def _pack(mesh, layout, pos, vel, tet, act):
    """The plain pack of the layout's table."""
    tab, width = _table(mesh, layout)
    return fused.pack_state(tab, pos, vel, tet, act, width)


def _jax_pack(jm, layout, pos, vel, tet, act):
    """The JAX package's mega of the same lanes (numpy in, numpy out)."""
    lanes = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(tet), jnp.asarray(act))
    if layout == "convex":
        return np.array(jfused_convex.pack_state(jm, jfused_convex.cx_table(jm), *lanes))
    ly = jfused.LAYOUT_PK if layout == "pk" else jfused.LAYOUT_TET
    return np.array(jfused.pack_state(jm, *lanes, ly))


def _lanes(n, nt, dtype, device, seed):
    """Random lanes: pos, vel, tet int32 with ~1/8 negative (escaped,
    absorbed, remote codes), active bool."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-1.0, 5.0, size=(n, 3)), dtype=dtype, device=device)
    vel = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=device)
    tet = rng.integers(0, nt, size=n)
    neg = rng.uniform(size=n) < 0.125
    tet[neg] = -rng.integers(1, 3 * nt, size=int(neg.sum()))
    tet = torch.as_tensor(tet, dtype=torch.int32, device=device)
    act = torch.as_tensor(rng.uniform(size=n) > 0.1, device=device)
    return pos, vel, tet, act


def _bits(t):
    """A float tensor's bit patterns (so -0.0 and 0.0 differ)."""
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a).cpu() if a.is_floating_point() else a.cpu(),
        _bits(b).cpu() if b.is_floating_point() else b.cpu())


def _box_run(device, dtype=torch.float32, n=300, **kw):
    mesh = _mesh(4, dtype, device)
    st = cpt.seed_in_box(n, (0.5,) * 3, (3.5,) * 3, rng_seed=3, dtype=dtype, device=device)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh),
                                                         st.pos))
    return mesh, st, cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3, **kw)


def _cfg_kw(layout):
    return {"tet": {}, "pk": {"velocity_interp": "VertexVelocity"},
            "convex": {"locate_mode": "convex"}}[layout]


# ---------------------------------------------------------------- the CPU


@pytest.fixture(scope="module", params=DTYPES, ids=("f32", "f64"))
def cpu_mesh(request):
    return _mesh(4, request.param, CPU)


@pytest.fixture(scope="module", params=DTYPES, ids=("f32", "f64"))
def both_meshes(request):
    """(JAX mesh, port mesh) of one box payload, with the Pk and convex rows."""
    np_dtype = np.float32 if request.param == torch.float32 else np.float64
    pts, tets, vv = tmesh.box_points_tets(4, 4, 4)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1), vert_vel=vv,
                                     dtype=np_dtype)
    jm = jmesh.with_convex_rows(jmesh.with_pk_rows(jmesh.host_to_device(dict(payload))))
    tm = cpt.with_convex_rows(cpt.with_pk_rows(convert.to_mesh(payload, device=CPU)))
    return jm, tm


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_pack_matches_jax(both_meshes, layout):
    """Ragged n, negative tets: the plain pack is the JAX package's
    ``pack_state`` bit for bit, and its head, row and pad columns are as
    the layout places them."""
    jm, tm = both_meshes
    tab, width = _table(tm, layout)
    n, tw = 1037, tab.shape[1]
    pos, vel, tet, act = _lanes(n, tm.n_tets, tab.dtype, CPU, seed=11)
    m = fused_cuda.pack_rows(tab, pos, vel, tet, act, width)
    want = _jax_pack(jm, layout, pos.numpy(), vel.numpy(), tet.numpy(), act.numpy())
    assert _same(m, torch.from_numpy(want))
    assert _same(m, _pack(tm, layout, pos, vel, tet, act))
    assert m.shape == (n, width)
    assert _same(m[:, 0:3], pos) and _same(m[:, 3:6], vel)
    assert torch.equal(m[:, 6].to(torch.int32), tet) and torch.equal(m[:, 7] > 0.5, act)
    assert _same(m[:, 8 : 8 + tw], tab[tet.long().clamp(min=0)])
    assert (tet < 0).any() and _same(m[tet < 0, 8 : 8 + tw], tab[0].expand(int((tet < 0).sum()),
                                                                        tw))
    assert not _bits(m[:, 8 + tw :]).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_unpack_matches_jax(both_meshes, layout):
    """The plain unpack of the JAX mega (ragged n, negative tets) is the
    JAX package's ``unpack_state`` bit for bit, with a zero disp."""
    jm, tm = both_meshes
    tab, width = _table(tm, layout)
    pos, vel, tet, act = _lanes(999, tm.n_tets, tab.dtype, CPU, seed=13)
    jmega = _jax_pack(jm, layout, pos.numpy(), vel.numpy(), tet.numpy(), act.numpy())
    got = fused_cuda.unpack_rows(torch.from_numpy(jmega))
    want = [torch.from_numpy(np.array(x)) for x in jfused.unpack_state(jnp.asarray(jmega))]
    assert len(got) == 5
    for g, w in zip(got[:4], want):
        assert _same(g, w)
    assert _same(got[2], tet) and (got[2] < 0).any()
    assert got[4].shape == (999, 3) and got[4].dtype == tab.dtype and not _bits(got[4]).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_unpack_then_pack_is_the_same_mega(cpu_mesh, layout):
    tab, width = _table(cpu_mesh, layout)
    pos, vel, tet, act = _lanes(777, cpu_mesh.n_tets, tab.dtype, CPU, seed=12)
    m = fused_cuda.pack_rows(tab, pos, vel, tet, act, width)
    pos2, vel2, tet2, act2, disp = fused_cuda.unpack_rows(m)
    assert _same(pos2, pos) and _same(vel2, vel) and _same(tet2, tet) and _same(act2, act)
    assert disp.shape == (777, 3) and disp.dtype == tab.dtype and not _bits(disp).any()
    assert _same(fused_cuda.pack_rows(tab, pos2, vel2, tet2, act2, width), m)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_result_is_fresh_on_the_cpu(layout):
    """Writing into what ``PackedRun.result`` returned leaves the run's mega
    as it was, and the result is the mega's head."""
    mesh, st, cfg = _box_run(CPU, **_cfg_kw(layout))
    run = PackedRun(mesh, st, cfg)
    run.advance(3, cfg.dt)
    out = run.result()
    before = run.m.clone()
    for t in (out.pos, out.vel, out.disp):
        t.fill_(7.0)
    out.tet_id.fill_(5)
    out.active.fill_(False)
    assert _same(run.m, before)
    again = run.result()
    assert _same(again.pos, before[:, 0:3].contiguous()) and _same(again.vel,
                                                                   before[:, 3:6].contiguous())
    assert torch.equal(again.tet_id, before[:, 6].to(torch.int32))
    assert torch.equal(again.active, before[:, 7] > 0.5)
    assert again.step == st.step + 3 and not again.disp.any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_set_mesh_packs_what_a_new_call_would(layout):
    """``set_mesh`` on a mesh with new velocities = a pack of the unpacked
    state on that mesh."""
    mesh, st, cfg = _box_run(CPU, dtype=torch.float64, **_cfg_kw(layout))
    run = PackedRun(mesh, st, cfg)
    run.advance(2, cfg.dt)
    out = run.result()
    mesh2 = cpt.replace_velocity(mesh, tet_vel=-2.0 * mesh.host["tet_vel"],
                                 vert_vel=-2.0 * mesh.host["vert_vel"])
    run.set_mesh(mesh2)
    assert _same(run.m, _pack(mesh2, layout, out.pos, out.vel, out.tet_id, out.active))
    assert not _same(run.m, _pack(mesh, layout, out.pos, out.vel, out.tet_id, out.active))


def test_no_launch_on_the_cpu():
    """The plain versions run on CPU tensors: the counters stay 0, and the
    recorder reads them at the call's outermost span."""
    from torch.profiler import ProfilerActivity, profile

    mesh, st, cfg = _box_run(CPU)
    RECORDER.new_window()
    with profile(activities=[ProfilerActivity.CPU]):
        cpt.run_cycles(mesh, st, cfg, 2)
    (top,) = [sp for sp in RECORDER.spans if sp.name == "run_cycles"]
    assert top.counts["launches.pack_rows"] == top.counts["launches.unpack_rows"] == 0
    assert fused_cuda.pack_rows.launches == fused_cuda.unpack_rows.launches == 0


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_kernels_equal_their_plain_versions(card, dtype):
    """65,536 and 65,499 lanes, every layout: each kernel = its plain
    version (``fused.pack_state``; the CPU branch of ``unpack_rows``) bit
    for bit, with negative tets, pos a row-strided view (taken as it is)
    and a column-strided one (copied)."""
    mesh = _mesh(16, dtype, card)
    for layout in LAYOUTS:
        tab, width = _table(mesh, layout)
        tab_cpu = tab.cpu()
        for n in (65_536, 65_499):
            pos, vel, tet, act = _lanes(n, mesh.n_tets, dtype, card, seed=n + width)
            wide = torch.zeros((n, 9), dtype=dtype, device=card)
            wide[:, 2:5] = pos
            for p in (pos, wide[:, 2:5], pos.t().contiguous().t()):
                m = fused_cuda.pack_rows(tab, p, vel, tet, act, width)
                want = fused.pack_state(tab_cpu, p.cpu(), vel.cpu(), tet.cpu(), act.cpu(), width)
                assert _same(m, want), (layout, n, p.stride())
            outs = fused_cuda.unpack_rows(m)
            for got, want in zip(outs, fused_cuda.unpack_rows(m.cpu())):
                assert _same(got, want), (layout, n)
            # the mega's own head as pos and vel: what set_mesh would hand over
            m2 = fused_cuda.pack_rows(tab, m[:, 0:3], m[:, 3:6], outs[2], outs[3], width)
            assert _same(m2, m), (layout, n)
    torch.cuda.synchronize()


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_call_launches_each_kernel_once(card, layout):
    """One ``run_cycles`` call: one pack_kernel and one unpack_kernel, and
    no torch gather, copy or fill on the device besides the noise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mesh, st, cfg = _box_run(card, n=65_536, **_cfg_kw(layout))
    cpt.run_cycles(mesh, st, cfg, 2)          # builds and loads the kernels
    torch.cuda.synchronize()
    before = (fused_cuda.pack_rows.launches, fused_cuda.unpack_rows.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cpt.run_cycles(mesh, st, cfg, 3)
        torch.cuda.synchronize()
    assert (fused_cuda.pack_rows.launches - before[0],
            fused_cuda.unpack_rows.launches - before[1]) == (1, 1)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not any("gather" in k for k in names), names
    # the kernels of the port and the three sub-steps' noise draws, nothing else
    assert [k for k in names if "cpf::" not in k and "distribution_" not in k] == [], names
    assert sum("pack_kernel" in k and "unpack" not in k for k in names) == 1, names
    assert sum("unpack_kernel" in k for k in names) == 1, names
