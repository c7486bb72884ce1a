"""PyTorch port: the partitioned strategy (``parallel/partition.py``) and the
remote-pausing rare stage, against the JAX package on the same inputs.

Twins of ``tests/test_partition.py``: the same box 8^3, 512 particles, 8
shards (the JAX side on the 8 virtual CPU devices of ``tests/conftest.py``,
the port's on ``cpu``), float64.  Port against JAX: tet and active exact,
pos within 1e-12, the migrated and deferred counts equal.  Two JAX tests
draw JAX's pid-keyed threefry noise, which torch cannot reproduce
(``test_partition.py:188, :438``); their twins hold the port against
itself through its pid-keyed "rbg" stream: S = 2 against S = 8, the mega
runner against the step loop, and both against the port's single-device
run under ``brownian_rng="rbg"`` (pos within 1e-6 as JAX's own
single-device checks, tet and active exact).
"""

import dataclasses
import functools

from torch_port_common import CPU   # also caps torch at one thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import cudaparticlesfoam_tpu.mesh as jmesh  # noqa: E402
from cudaparticlesfoam_tpu import StepConfig as JStepConfig  # noqa: E402
from cudaparticlesfoam_tpu import locate_seeds as jlocate_seeds  # noqa: E402
from cudaparticlesfoam_tpu import build_grid_locator as jbuild_locator  # noqa: E402
from cudaparticlesfoam_tpu import seed_in_box as jseed_in_box  # noqa: E402
from cudaparticlesfoam_tpu.ops import fused as jfused  # noqa: E402
from cudaparticlesfoam_tpu.parallel import partition as jpart  # noqa: E402
from cudaparticlesfoam_tpu.parallel import sharding as jshard  # noqa: E402
from cudaparticlesfoam_tpu.parallel.auto import ParticleEngine as JEngine  # noqa: E402
from cudaparticlesfoam_tpu.state import inject as jinject  # noqa: E402
from cudaparticlesfoam_tpu.state import make_state as jmake_state  # noqa: E402
from cudaparticlesfoam_tpu.state import replace as jreplace  # noqa: E402
from cudaparticlesfoam_tpu_torch import StepConfig, convert, run_cycles  # noqa: E402
from cudaparticlesfoam_tpu_torch import mesh as tmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch import state as tstate  # noqa: E402
from cudaparticlesfoam_tpu_torch.ops import fused, fused_cuda  # noqa: E402
from cudaparticlesfoam_tpu_torch.ops import locate as tlocate  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import partition  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel.auto import ParticleEngine  # noqa: E402

S = 8
NSIDE, N = 8, 512
POS_TOL = 1e-12       # port against JAX, float64
SINGLE_TOL = 1e-6     # against a single-device run (tests/test_partition.py's bound)
CPUS = [CPU] * S


def _field(kind, cen):
    r = cen[:, :2] - 4.0
    u = np.zeros_like(cen)
    out = cen - 4.0
    out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-12
    if kind == "circ":
        u[:, 0], u[:, 1] = -r[:, 1] * 0.3, r[:, 0] * 0.3
    elif kind == "skew":
        u[:, 0] = 1.0
    elif kind == "outward":
        u = out * 1.5
    elif kind == "drain":
        u = out * 1.2
    elif kind == "convex":
        u[:, 0] = -r[:, 1] * 0.3 + out[:, 0] * 0.4
        u[:, 1] = r[:, 0] * 0.3 + out[:, 1] * 0.4
        u[:, 2] = out[:, 2] * 0.4
    return u


@functools.lru_cache(maxsize=None)
def meshes(kind, escape=False, pk=False, convex=False):
    """(JAX mesh, port mesh) of one payload: the box with the field
    ``kind`` (per tet, or with ``pk`` the circulation at the vertices),
    every patch absorbing with ``escape``."""
    pts, tets, _ = tmesh.box_points_tets(NSIDE, NSIDE, NSIDE)
    vv = np.zeros_like(pts, dtype=np.float64)
    if pk:
        r = pts[:, :2] - 4.0
        vv[:, 0], vv[:, 1] = -r[:, 1] * 0.3, r[:, 0] * 0.3
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=_field(kind, pts[tets].mean(axis=1)),
                                     vert_vel=vv, dtype=np.float64)
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    if escape:
        jm, tm = jmesh.set_boundary_escape(jm, [0]), tmesh.set_boundary_escape(tm, [0])
    if pk:
        jm, tm = jmesh.with_pk_rows(jm), tmesh.with_pk_rows(tm)
    if convex:
        jm, tm = jmesh.with_convex_rows(jm), tmesh.with_convex_rows(tm)
    return jm, tm


@pytest.fixture(scope="module")
def seeds():
    """tests/test_partition.py's 512 seeds (JAX's threefry seeding in
    [0.5, 7.5]^3), located: (pos, tet) as numpy."""
    jm, _ = meshes("circ")
    pos = np.asarray(jseed_in_box(N, (0.5,) * 3, (7.5,) * 3, method="threefry").pos,
                     np.float64)
    tet = np.asarray(jlocate_seeds(jm, jbuild_locator(jm), jnp.asarray(pos)))
    assert (tet >= 0).all()
    return pos, tet


def jstate(seeds, active=None):
    pos, tet = seeds
    st = jmake_state(pos, tet_id=tet, dtype=jnp.float64)
    if active is not None:
        st = jreplace(st, active=jnp.asarray(active),
                      tet_id=jnp.where(jnp.asarray(active), st.tet_id, -(st.tet_id + 1)))
    return st


def tstate_of(st):
    return convert.to_state(st.pos, st.tet_id, vel=st.vel, active=st.active,
                            dtype=torch.float64, device=CPU)


def layout_of(cfg):
    if cfg.locate_mode == "convex":
        return "cx"
    return "pk" if cfg.velocity_interp == "VertexVelocity" else "tet"


def jax_step(cfg, per):
    """JAX's partitioned step of ``cfg``, compiled once for every test of
    that configuration: it takes the mesh and dt as arguments."""
    return _jax_step(dataclasses.replace(cfg, dt=0.0), per)


@functools.lru_cache(maxsize=None)
def _jax_step(cfg, per):
    stub = jpart.PartitionedMesh(tet_row=None, tet_nbr=None, perm=None, inv_perm=None,
                                 bd_escape=None, n_shards=S, tets_per_shard=per, n_tets=0)
    return jpart.make_partitioned_step(stub, cfg, jshard.make_device_mesh(S, axis="s"))


def run_jax(jm, st, cfg, n_cycles, slack=2.0, keep=(), capacity=None):
    """JAX's step loop: (slot arrays after the last cycle, [(migrated,
    deferred)] per cycle, {cycle: JAX's ShardedParticles} for the cycles in
    ``keep``).
    The slots are compared before any settle step, so the JAX side
    compiles one program per configuration."""
    pm = jpart.partition_mesh(jm, S, layout=layout_of(cfg))
    dmesh = jshard.make_device_mesh(S, axis="s")
    sp = jpart.distribute_particles(pm, st.pos, st.vel, st.tet_id, st.active,
                                    rng_key=st.rng_key, slack=slack, capacity=capacity)
    pm, sp = jpart.shard_arrays(pm, sp, dmesh)
    step = jax_step(cfg, pm.tets_per_shard)
    counts, kept = [], {}
    for i in range(n_cycles):
        sp, ms = step(pm, sp, cfg.dt)
        counts.append((int(ms["migrated"]), int(ms["deferred"])))
        if i + 1 in keep:
            kept[i + 1] = sp
    return slots(sp), counts, kept


def port_setup(tm, st, cfg, n_shards=S, slack=2.0):
    pm = partition.partition_mesh(tm, n_shards, layout=layout_of(cfg))
    sp = partition.distribute_particles(pm, st.pos, st.vel, st.tet_id, st.active,
                                        seed=st.seed, slack=slack)
    return pm, sp


def run_port(tm, st, cfg, n_cycles, n_shards=S, slack=2.0, runner=False, keep=()):
    """The port's step loop (or mega runner): (the arrays collected after a
    settle step, per-cycle counts, {cycle: slots}, the slots before the
    settle step)."""
    pm, sp = port_setup(tm, st, cfg, n_shards, slack)
    devs = [CPU] * n_shards
    counts, kept = [], {}
    if runner:
        sp, ms = partition.make_partitioned_runner(pm, cfg, devs, n_cycles)(pm, sp, cfg.dt)
        counts = [(int(ms["migrated"]), int(ms["deferred"]))]
    else:
        step = partition.make_partitioned_step(pm, cfg, devs)
        for i in range(n_cycles):
            sp, ms = step(pm, sp, cfg.dt)
            counts.append((int(ms["migrated"]), int(ms["deferred"])))
            if i + 1 in keep:
                kept[i + 1] = sp
    settled, _ = partition.make_settle_step(pm, cfg, devs)(pm, sp, cfg.dt)
    return partition.collect_particles(pm, settled, st.n_particles), counts, kept, sp


def assert_slots(got, ref):
    """Slot arrays (:func:`slots`) of the port against JAX's: the same
    slots resident; on them tet, pid and active exact, pos within 1e-12."""
    res = ref["resident"]
    np.testing.assert_array_equal(got["resident"], res)
    for f in ("tet", "pid", "active"):
        np.testing.assert_array_equal(got[f][res], ref[f][res], err_msg=f)
    np.testing.assert_allclose(got["pos"][res], ref["pos"][res], atol=POS_TOL, rtol=0)


def assert_same(got, ref, tol=POS_TOL):
    pos, vel, tet, act = got
    np.testing.assert_array_equal(tet, np.asarray(ref[2]))
    np.testing.assert_array_equal(act, np.asarray(ref[3]))
    np.testing.assert_allclose(pos, np.asarray(ref[0]), atol=tol, rtol=0)


def assert_matches_state(got, ref, tol=SINGLE_TOL):
    assert_same(got, (ref.pos.numpy(), None, ref.tet_id.numpy(), ref.active.numpy()), tol)


def slots(sp):
    """[S, C, ...] numpy slot arrays of a port or JAX ShardedParticles."""
    def st(x):
        return np.stack([np.asarray(a) for a in x]) if isinstance(x, list) else np.asarray(x)
    return {f: st(getattr(sp, f)) for f in ("pos", "tet", "active", "resident", "pid")}


# ---------------------------------------------------------------------------
# twins of tests/test_partition.py
# ---------------------------------------------------------------------------


def test_partitioned_matches_single_device(seeds):
    jm, tm = meshes("circ")
    st = jstate(seeds)
    cfg = JStepConfig(dt=0.05, use_brownian=False, engine="simple")
    ref, jcounts, _ = run_jax(jm, st, cfg, 40)
    tcfg = StepConfig(dt=0.05, use_brownian=False, engine="simple")
    got, counts, _, sp = run_port(tm, tstate_of(st), tcfg, 40)
    assert counts == jcounts and sum(c[0] for c in counts) > 0
    assert sum(int(r.sum()) for r in sp.resident) == N        # loss-free
    assert_slots(slots(sp), ref)
    assert_matches_state(got, run_cycles(tm, tstate_of(st), tcfg, 40))


def test_partitioned_no_loss_under_skew(seeds):
    # uniform +x flow piles the particles into the last slab: admission
    # defers, never drops
    jm, tm = meshes("skew")
    st = jstate(seeds)
    cfg = JStepConfig(dt=0.05, use_brownian=False, engine="simple")
    ref, jcounts, _ = run_jax(jm, st, cfg, 60, slack=8.0)
    got, counts, _, sp = run_port(tm, tstate_of(st), StepConfig(dt=0.05, use_brownian=False),
                                  60, slack=8.0)
    assert counts == jcounts
    assert sum(int(r.sum()) for r in sp.resident) == N
    assert_slots(slots(sp), ref)
    assert (got[2] >= 0).all() and (got[0][:, 0] > 4.0).mean() > 0.9


def test_partition_mesh_structure():
    jm, tm = meshes("circ")
    pm = partition.partition_mesh(tm, S)
    jpm = jpart.partition_mesh(jm, S)
    per = pm.tets_per_shard
    assert len(pm.tet_row) == S and pm.tet_row[0].shape == (per, 20)
    np.testing.assert_array_equal(np.stack([r.numpy() for r in pm.tet_row]),
                                  np.asarray(jpm.tet_row))
    np.testing.assert_array_equal(np.stack([r.numpy() for r in pm.tet_nbr]),
                                  np.asarray(jpm.tet_nbr))
    perm, inv = pm.perm.numpy(), pm.inv_perm.numpy()
    np.testing.assert_array_equal(perm, np.asarray(jpm.perm))
    np.testing.assert_array_equal(perm[inv], np.arange(tm.n_tets))
    cen = tm.host["points"][tm.host["tets"]].mean(axis=1)[inv]
    means = [cen[s * per:(s + 1) * per, 0].mean() for s in range(S - 1)]
    assert all(means[i] <= means[i + 1] + 1e-9 for i in range(len(means) - 1))


def test_partitioned_escape_patches(seeds):
    jm, tm = meshes("outward", escape=True)
    st = jstate(seeds)
    cfg = JStepConfig(dt=0.1, use_brownian=False, engine="simple")
    ref, jcounts, _ = run_jax(jm, st, cfg, 40)
    tcfg = StepConfig(dt=0.1, use_brownian=False, engine="simple")
    got, counts, _, sp = run_port(tm, tstate_of(st), tcfg, 40)
    assert counts == jcounts
    assert int((~got[3]).sum()) > 100                          # the field drains particles
    assert_slots(slots(sp), ref)
    single = run_cycles(tm, tstate_of(st), tcfg, 40)
    assert_matches_state(got, single, tol=1e-9)


def test_partitioned_pk_layout(seeds):
    jm, tm = meshes("circ", pk=True)
    st = jstate(seeds)
    kw = dict(dt=0.05, use_brownian=False, engine="simple", velocity_interp="VertexVelocity")
    ref, jcounts, _ = run_jax(jm, st, JStepConfig(**kw), 40)
    got, counts, _, sp = run_port(tm, tstate_of(st), StepConfig(**kw), 40)
    assert counts == jcounts and sum(c[0] for c in counts) > 0
    assert_slots(slots(sp), ref)
    assert_matches_state(got, run_cycles(tm, tstate_of(st), StepConfig(**kw), 40), tol=1e-9)


def test_partitioned_brownian_stable_across_shard_counts(seeds):
    """Noise keyed by (seed, step, pid): the same trajectories on 2 and 8
    shards, through the mega runner and the step loop, and those of a
    single-device run under brownian_rng="rbg"."""
    _, tm = meshes("circ")
    st = tstate_of(jstate(seeds))
    cfg = StepConfig(dt=0.05, diffusion_coeff=5e-4, engine="simple")
    a = run_port(tm, st, cfg, 30, n_shards=2)[0]
    b = run_port(tm, st, cfg, 30, n_shards=8)[0]
    c = run_port(tm, st, cfg, 30, n_shards=8, runner=True)[0]
    np.testing.assert_allclose(a[0], b[0], atol=1e-12, rtol=0)
    np.testing.assert_array_equal(a[2], b[2])
    for x, y in zip(b, c):
        np.testing.assert_array_equal(x, y)
    single = run_cycles(tm, st, StepConfig(dt=0.05, diffusion_coeff=5e-4, engine="simple",
                                           brownian_rng="rbg"), 30)
    assert_matches_state(a, single)
    assert np.abs(a[0] - st.pos.numpy()).max() > 0.01          # the kicks moved them


def test_partitioned_velocity_refresh_layouts():
    """update_velocity reproduces a fresh partition's rows for the three
    layouts (tet 20, cx 24, pk 32 columns), which equal JAX's (its pk rows
    are 29 wide: the port pads them to 32 as its kernels read them)."""
    jm, tm = meshes("circ")
    rng = np.random.default_rng(3)
    u2 = rng.normal(size=(tm.n_tets, 3))
    vv2 = rng.normal(size=(tm.n_points, 3))

    def rows(pm):
        return np.stack([r.numpy() for r in pm.tet_row])

    for layout, prep, jprep in (("tet", lambda m: m, lambda m: m),
                                ("cx", tmesh.with_convex_rows, jmesh.with_convex_rows)):
        pm = partition.partition_mesh(prep(tm), S, layout=layout)
        fresh = partition.partition_mesh(prep(tmesh.replace_velocity(tm, tet_vel=u2)), S,
                                         layout=layout)
        np.testing.assert_array_equal(rows(partition.update_velocity(pm, u2)), rows(fresh))
        jfresh = jpart.partition_mesh(jprep(jmesh.replace_velocity(jm, tet_vel=u2)), S,
                                      layout=layout)
        np.testing.assert_array_equal(rows(fresh), np.asarray(jfresh.tet_row))
    base = tmesh.with_pk_rows(tmesh.replace_velocity(tm, vert_vel=np.zeros_like(vv2)))
    pm = partition.partition_mesh(base, S, layout="pk")
    fresh = partition.partition_mesh(tmesh.with_pk_rows(tmesh.replace_velocity(tm, vert_vel=vv2)),
                                     S, layout="pk")
    upd = partition.update_velocity(pm, None, vert_vel=vv2, tets=tm.tets)
    np.testing.assert_array_equal(rows(upd), rows(fresh))
    jfresh = jpart.partition_mesh(jmesh.with_pk_rows(jmesh.replace_velocity(jm, vert_vel=vv2)),
                                  S, layout="pk")
    np.testing.assert_array_equal(rows(fresh)[..., :29], np.asarray(jfresh.tet_row))
    assert not rows(fresh)[..., 29:].any()


def test_partitioned_convex_needs_rows(seeds):
    _, tm = meshes("circ")
    with pytest.raises(ValueError, match="with_convex_rows"):
        ParticleEngine(tm, tstate_of(jstate(seeds)), StepConfig(locate_mode="convex"),
                       devices=S, strategy="partitioned", log=lambda *a: None)


def test_partitioned_convex_matches_single(seeds):
    jm, tm = meshes("convex", convex=True)
    st = jstate(seeds)
    kw = dict(dt=0.08, use_brownian=False, engine="simple", locate_mode="convex",
              convex_bary_fix=False)
    ref, jcounts, _ = run_jax(jm, st, JStepConfig(**kw), 40)
    got, counts, _, sp = run_port(tm, tstate_of(st), StepConfig(**kw), 40)
    assert counts == jcounts and sum(c[0] for c in counts) > 0
    assert_slots(slots(sp), ref)
    assert_matches_state(got, run_cycles(tm, tstate_of(st), StepConfig(**kw), 40), tol=1e-9)


def test_dp_rbg_kernel_not_downgraded_and_disjoint(seeds):
    """DP keeps rbg_kernel: shard s keys its Philox stream with lane
    offset s * 8192, bit for bit JAX's XLA "rbg" stream of that shard, so
    the per-shard streams are disjoint; the trajectories equal JAX's."""
    jm, tm = meshes("circ")
    st = jstate(seeds)
    kw = dict(dt=0.05, diffusion_coeff=1e-3, use_advection=False, reflect_wall=True,
              brownian_rng="rbg_kernel")
    jeng = JEngine(jm, st, JStepConfig(**kw), devices=S, strategy="dp", log=lambda *a: None)
    jeng.advance(5, 0.05)
    ref = jeng.snapshot()
    eng = ParticleEngine(tm, tstate_of(st), StepConfig(**kw), devices=S, strategy="dp",
                         log=lambda *a: None)
    assert eng.cfg.brownian_rng == "rbg_kernel" and eng._dp.lane_offsets
    eng.advance(5, 0.05)
    out = eng.snapshot()
    np.testing.assert_array_equal(out.tet_id.numpy(), np.asarray(ref.tet_id))
    np.testing.assert_array_equal(out.active.numpy(), np.asarray(ref.active))
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos), atol=POS_TOL, rtol=0)
    # the stream's bits, bit for bit: shard 3's key at step 2
    key = fused.philox_key(0, 2, lane_offset=3 * 8192)
    _, jbits = jax.lax.rng_bit_generator(jnp.asarray(key, jnp.uint32), (N // S, 4),
                                         dtype=jnp.uint32)
    np.testing.assert_array_equal(fused.philox_bits(key, N // S).numpy(),
                                  np.asarray(jbits).astype(np.int64))
    assert out.active.all() and (out.tet_id >= 0).all()
    disp = out.pos.numpy() - np.asarray(st.pos)
    per = N // S
    assert not np.allclose(disp[:per], disp[per:2 * per])
    var = disp.var(axis=0).mean()
    expect = 2.0 * 1e-3 * 0.05 * 5
    assert 0.5 * expect < var < 1.5 * expect


def test_partitioned_injection_via_engine(seeds):
    """set_state re-distributes into the existing slots (same capacity):
    the port's engine takes JAX's injection of its snapshot and follows
    JAX's partitioned steps from it; and with the port's own injection the
    partitioned engine follows the single one."""
    jm, tm = meshes("circ")
    act = np.ones(N, bool)
    act[::3] = False
    st = jstate(seeds, active=act)
    kw = dict(dt=0.05, use_brownian=False, engine="simple")
    eng = ParticleEngine(tm, tstate_of(st), StepConfig(**kw), devices=S,
                         strategy="partitioned", log=lambda *a: None)
    assert eng.supports_injection
    eng.advance(10, 0.05)
    t10 = eng.snapshot()
    assert t10.step == 10
    j10 = jmake_state(t10.pos.numpy(), tet_id=t10.tet_id.numpy(), dtype=jnp.float64)
    j10 = jreplace(j10, vel=jnp.asarray(t10.vel.numpy()), active=jnp.asarray(t10.active.numpy()),
                   step=jnp.asarray(10, jnp.int32))
    jinj, n_inj = jinject(j10, jm, jbuild_locator(jm), (0.5,) * 3, (7.5,) * 3, count=200,
                          rng_seed=9)
    assert n_inj > 0
    ref, jcounts, _ = run_jax(jm, jinj, JStepConfig(**kw), 10, capacity=eng._sp.capacity)
    eng.set_state(convert.to_state(jinj.pos, jinj.tet_id, vel=jinj.vel, active=jinj.active,
                                   step=10, dtype=torch.float64, device=CPU))
    eng.advance(10, 0.05)
    assert eng.migration_stats["migrated"] > 0
    assert_slots(slots(eng._slots()), ref)

    loc = tlocate.build_grid_locator(tm)

    def drive(strategy, devices):
        e = ParticleEngine(tm, tstate_of(st), StepConfig(**kw), devices=devices,
                           strategy=strategy, log=lambda *a: None)
        e.advance(10, 0.05)
        s, k = tstate.inject(e.snapshot(), tm, loc, (0.5,) * 3, (7.5,) * 3, count=200,
                             rng_seed=9)
        e.set_state(s)
        e.advance(10, 0.05)
        return e.snapshot(), k

    ref, k_ref = drive("single", 1)
    out, k_out = drive("partitioned", S)
    assert k_ref == k_out > 0
    assert_matches_state((out.pos.numpy(), None, out.tet_id.numpy(), out.active.numpy()), ref)


def test_partitioned_geometry_refresh(seeds):
    """refresh_geometry rebuilds the per-shard tables of a rigidly moved
    mesh in place (same shapes) equal to a fresh partition and to JAX's,
    and stepping follows JAX's and the single-device engine's."""
    jm, tm = meshes("circ")
    st = jstate(seeds)
    shift = np.array([0.25, -0.1, 0.05])
    moved = tmesh.refresh_geometry(tm, tm.points + torch.as_tensor(shift))
    jmoved = jmesh.refresh_geometry(jm, jm.points + jnp.asarray(shift))
    pm = partition.partition_mesh(tm, S)
    pm2 = partition.refresh_geometry(pm, moved)
    fresh = partition.partition_mesh(moved, S)
    jpm2 = jpart.refresh_geometry(jpart.partition_mesh(jm, S), jmoved)
    for a, b, c in zip(pm2.tet_row, fresh.tet_row, np.asarray(jpm2.tet_row)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(a.numpy(), c, atol=1e-12, rtol=0)

    stm = jreplace(st, pos=st.pos + jnp.asarray(shift))
    cfg = JStepConfig(dt=0.05, use_brownian=False, engine="simple")
    ref, jcounts, _ = run_jax(jmoved, stm, cfg, 30)
    tcfg = StepConfig(dt=0.05, use_brownian=False, engine="simple")
    sp = partition.distribute_particles(pm2, torch.as_tensor(np.asarray(stm.pos)),
                                        torch.as_tensor(np.asarray(stm.vel)),
                                        torch.as_tensor(np.asarray(stm.tet_id)),
                                        torch.as_tensor(np.asarray(stm.active)))
    step = partition.make_partitioned_step(pm2, tcfg, CPUS)
    counts = []
    for _ in range(30):
        sp, ms = step(pm2, sp, 0.05)
        counts.append((int(ms["migrated"]), int(ms["deferred"])))
    assert counts == jcounts
    assert_slots(slots(sp), ref)
    sp, _ = partition.make_settle_step(pm2, tcfg, CPUS)(pm2, sp, 0.05)
    got = partition.collect_particles(pm2, sp, N)
    assert_matches_state(got, run_cycles(moved, tstate_of(stm), tcfg, 30))


def test_partitioned_runner_matches_step_loop(seeds):
    """The mega runner = the step loop on resident slots, bit for bit, with
    the same migration count; the step loop's slots = JAX's; and the port's
    step from JAX's own slots (convert.to_partitioned_mesh /
    to_sharded_particles) = JAX's next step."""
    jm, tm = meshes("circ")
    st = jstate(seeds)
    cfg = JStepConfig(dt=0.05, use_brownian=False, engine="simple")
    ref13, jcounts, kept = run_jax(jm, st, cfg, 13, keep=(12,))
    jpm = jpart.partition_mesh(jm, S)
    tpm = convert.to_partitioned_mesh(jpm, device=CPU)
    for a, b in zip(tpm.tet_row, partition.partition_mesh(tm, S).tet_row):
        assert torch.equal(a, b)
    tcfg0 = StepConfig(dt=0.05, use_brownian=False, engine="simple")
    sp13, ms = partition.make_partitioned_step(tpm, tcfg0, CPUS)(
        tpm, convert.to_sharded_particles(kept[12], device=CPU), 0.05)
    assert (int(ms["migrated"]), int(ms["deferred"])) == jcounts[12] and sp13.step == 13
    assert_slots(slots(sp13), ref13)
    jcounts = jcounts[:12]
    tcfg = StepConfig(dt=0.05, use_brownian=False, engine="simple")
    pm, sp0 = port_setup(tm, tstate_of(st), tcfg)
    step = partition.make_partitioned_step(pm, tcfg, CPUS)
    sp_loop, migrated = sp0, 0
    for _ in range(12):
        sp_loop, ms = step(pm, sp_loop, 0.05)
        migrated += int(ms["migrated"])
    sp_scan, stats = partition.make_partitioned_runner(pm, tcfg, CPUS, 12)(pm, sp0, 0.05)
    assert int(stats["migrated"]) == migrated == sum(c[0] for c in jcounts) > 0
    a, b, j = slots(sp_loop), slots(sp_scan), slots(kept[12])
    res = a["resident"]
    np.testing.assert_array_equal(b["resident"], res)
    np.testing.assert_array_equal(j["resident"], res)
    for f in ("pos", "tet", "pid", "active"):
        np.testing.assert_array_equal(b[f][res], a[f][res], err_msg=f)
    for f in ("tet", "pid", "active"):
        np.testing.assert_array_equal(a[f][res], j[f][res], err_msg=f)
    np.testing.assert_allclose(a["pos"][res], j["pos"][res], atol=POS_TOL, rtol=0)


def test_partitioned_runner_mega_brownian_escape(seeds):
    """Under pid-keyed noise, absorbing patches and migration pressure the
    mega runner = the step loop bit for bit.  (The single-device run under
    brownian_rng="rbg" is the reference without absorbing patches, in the
    shard-count twin: with them, the cached and the simple engine differ
    in when an absorbed lane drops, in JAX as in the port.)"""
    _, tm = meshes("drain", escape=True)
    st = tstate_of(jstate(seeds))
    cfg = StepConfig(dt=0.1, diffusion_coeff=5e-4, engine="simple")
    pm, sp0 = port_setup(tm, st, cfg)
    assert sp0.capacity % 8 == 0
    step = partition.make_partitioned_step(pm, cfg, CPUS)
    sp_loop, migrated = sp0, 0
    for _ in range(25):
        sp_loop, ms = step(pm, sp_loop, cfg.dt)
        migrated += int(ms["migrated"])
    assert migrated > 0
    sp_mega, stats = partition.make_partitioned_runner_mega(pm, cfg, CPUS, 25)(pm, sp0, cfg.dt)
    assert int(stats["migrated"]) == migrated
    a, b = slots(sp_loop), slots(sp_mega)
    res = a["resident"]
    assert int((~b["active"] & b["resident"]).sum()) > 50      # escapes exercised
    np.testing.assert_array_equal(b["resident"], res)
    assert sp_mega.step == sp_loop.step == 25
    for f in ("pos", "tet", "active", "pid"):
        np.testing.assert_array_equal(b[f][res], a[f][res], err_msg=f)


# ---------------------------------------------------------------------------
# the remote-pausing rare stage, and migration, against JAX's pieces
# ---------------------------------------------------------------------------


def _remote_inputs(tab, per, s, nb, ly, seed):
    """Lanes of shard ``s`` (of a 4-slab box) in its slab with targets
    beyond it: 'walk' targets cross into a neighbouring slab, 'corner'
    targets lie past the box's walls (bounces, some into another slab)."""
    rng = np.random.default_rng(seed)
    n = 2048
    tl = rng.integers(0, per, n)
    rows = tab[tl]
    a, tinv = rows[:, 0:3], rows[:, 3:12].reshape(n, 3, 3)
    # the centroid of the local tet: A + inverse(Tinv) @ (1/4, 1/4, 1/4)
    cen = a + np.einsum("nij,j->ni", np.linalg.inv(tinv), np.full(3, 0.25))
    half = n // 2
    tgt = cen.copy()
    tgt[:half] += rng.normal(scale=2.0, size=(half, 3))
    corner = rng.integers(0, 2, (n - half, 3)) * NSIDE
    tgt[half:] = corner + np.where(corner > 0, 1.0, -1.0) * rng.uniform(0.05, 2.5, (n - half, 3))
    m = np.zeros((n, ly.width))
    m[:, 0:3] = tgt
    m[:, 3:6] = rng.normal(size=(n, 3))
    m[:, 6] = tl
    m[:, 7] = 1.0
    m[:, 8:8 + tab.shape[1]] = rows
    pend = rng.uniform(size=n) < 0.8
    return m, pend


@pytest.mark.parametrize("layout", ["tet", "pk"])
def test_rare_plain_remote_matches_jax(layout):
    """rare_plain(remote=) = JAX's _rare_stage with _make_run_lanes_remote
    (and _reflect_mega(remote=)), on one shard of a 4-slab box: tet exact,
    pos/vel within 1e-12, lanes paused by the walk and by a bounce."""
    jm, tm = meshes("circ", pk=True)
    pm = partition.partition_mesh(tm, 4, layout=layout)
    jpm = jpart.partition_mesh(jm, 4, layout=layout)
    s, per = 1, pm.tets_per_shard
    tab = pm.tet_row[s]
    ly = fused.LAYOUT_PK if layout == "pk" else fused.LAYOUT_TET
    m0, pend = _remote_inputs(tab.numpy(), per, s, 4, ly, seed=7)
    cfg = StepConfig()
    m = torch.tensor(m0)
    fused_cuda.rare_resolve(tab, m, torch.as_tensor(pend.astype(np.uint8)), pm.bd_escape[s],
                            max_hops=cfg.max_hops, max_bounces=cfg.max_bounces,
                            reflect_wall=True, ly=ly, remote=(pm.bd_escape[s].shape[0], per))
    jrows = np.asarray(jpm.tet_row)[s]
    ctx = jpart._cached_ctx(jnp.asarray(jrows), jpm.bd_escape, per, JStepConfig(), jnp.float64)
    jm0 = np.zeros((m0.shape[0], ctx.ly.width))
    jm0[:, :8] = m0[:, :8]
    jm0[:, 8:8 + jrows.shape[1]] = jrows[m0[:, 6].astype(np.int64)]
    n = m0.shape[0]
    mj = np.asarray(jax.jit(lambda mm, pp: jfused._rare_stage(
        ctx.mesh_view, ctx.tab, mm, pp, ctx.cfg2, ctx.ly, n, n // 8, ctx.ly.width,
        run_lanes=ctx.run_lanes))(jnp.asarray(jm0), jnp.asarray(pend)))
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(got[:, 8:8 + jrows.shape[1]], mj[:, 8:8 + jrows.shape[1]],
                               atol=POS_TOL, rtol=0)
    paused = got[:, 6] < -per
    bounced = np.abs(got[:, 3:6] - m0[:, 3:6]).max(axis=1) > 0
    assert (paused & ~bounced).sum() > 0 and (paused & bounced).sum() > 0
    # the sentinel names a tet of another shard
    g = -got[paused, 6] - per - 1
    assert ((g // per) != s).all() and (g < tm.n_tets).all()


def _jax_shard_map(body, n_in, n_out, S_):
    dmesh = jshard.make_device_mesh(S_, axis="s")
    return jax.jit(shard_map(body, mesh=dmesh, in_specs=(P("s"),) * n_in,
                             out_specs=(P("s"),) * n_out))


def _slot_arrays(per, S_, C, seed):
    """Random slots of S_ shards: resident lanes on their own slab, others
    on a remote one (most toward shard 0, which has few free slots, so some
    are deferred), empty slots."""
    rng = np.random.default_rng(seed)
    res = rng.uniform(size=(S_, C)) < 0.7
    res[0] = rng.uniform(size=C) < 0.95                        # shard 0 nearly full
    own = np.arange(S_)[:, None] * per + rng.integers(0, per, (S_, C))
    to0 = rng.integers(0, per, (S_, C))
    other = ((np.arange(S_)[:, None] + rng.integers(1, S_, (S_, C))) % S_) * per \
        + rng.integers(0, per, (S_, C))
    kind = rng.uniform(size=(S_, C))
    tet = np.where(kind < 0.6, own, np.where(kind < 0.85, to0, other))
    tet = np.where(rng.uniform(size=(S_, C)) < 0.05, -(tet + 1), tet).astype(np.int32)
    tet = np.where(res, tet, -1).astype(np.int32)
    pid = np.where(res, np.arange(S_ * C).reshape(S_, C), -1).astype(np.int32)
    return dict(pos=rng.normal(size=(S_, C, 3)), vel=rng.normal(size=(S_, C, 3)),
                disp=np.zeros((S_, C, 3)), tet=tet, act=rng.uniform(size=(S_, C)) < 0.9,
                res=res, pid=pid)


def test_migrate_matches_jax():
    """_migrate (two-phase admission, quota by grant, overflow deferral,
    merge-by-gather placement) = JAX's on the same slot arrays."""
    S_, C, per, cap_out = 4, 96, 50, 12
    a = _slot_arrays(per, S_, C, seed=5)
    names = ("pos", "vel", "disp", "tet", "act", "res", "pid")

    def body(*xs):
        out = jpart._migrate(*(x[0] for x in xs), jax.lax.axis_index("s"), per, S_, cap_out)
        return tuple(o[None] for o in out)

    jo = _jax_shard_map(body, 7, 9, S_)(*(jnp.asarray(a[k]) for k in names))
    to = partition._migrate(*([torch.as_tensor(x) for x in a[k]] for k in names), per,
                            [CPU] * S_, cap_out)
    for i, k in enumerate(names):
        got = np.stack([t.numpy() for t in to[i]])
        np.testing.assert_array_equal(got, np.asarray(jo[i]), err_msg=k)
    assert int(to[7]) == int(np.asarray(jo[7]).sum()) > 0
    assert int(to[8]) == int(np.asarray(jo[8]).sum()) > 0      # deferral exercised


def test_migrate_mega_matches_jax():
    """_migrate_mega on resident mega rows (arrivals re-packed against the
    destination's table) = JAX's on the same megas."""
    jm, tm = meshes("circ")
    S_, C = 4, 96
    pm = partition.partition_mesh(tm, S_)
    jpm = jpart.partition_mesh(jm, S_)
    per = pm.tets_per_shard
    cap_out = 12
    a = _slot_arrays(per, S_, C, seed=6)
    megas = []
    for s in range(S_):
        lo = s * per
        tet = a["tet"][s]
        own = (tet >= lo) & (tet < lo + per)
        tl = np.where(own, tet - lo, np.where(tet >= 0, -(per + tet + 1), -1))
        m = np.zeros((C, 32))
        m[:, 0:3], m[:, 3:6] = a["pos"][s], a["vel"][s]
        m[:, 6] = np.where(a["res"][s], tl, 0)
        m[:, 7] = a["act"][s] & own
        m[:, 8:28] = pm.tet_row[s].numpy()[np.clip(tl, 0, per - 1)]
        megas.append(m)
    megas = np.stack(megas)

    def body(rows, bd, m, act, res, pid):
        ctx = jpart._cached_ctx(rows[0], bd, per, JStepConfig(), jnp.float64)
        out = jpart._migrate_mega(ctx, m[0], act[0], res[0], pid[0], jax.lax.axis_index("s"),
                                  per, S_, cap_out)
        return tuple(o[None] for o in out)

    dmesh = jshard.make_device_mesh(S_, axis="s")
    f = jax.jit(shard_map(body, mesh=dmesh, in_specs=(P("s"), P()) + (P("s"),) * 4,
                          out_specs=(P("s"),) * 6))
    jo = f(jpm.tet_row, jpm.bd_escape, jnp.asarray(megas), jnp.asarray(a["act"]),
           jnp.asarray(a["res"]), jnp.asarray(a["pid"]))
    ctxs = [partition._CachedCtx(pm.tet_row[s], pm.bd_escape[s], per, StepConfig())
            for s in range(S_)]
    m = [torch.as_tensor(x) for x in megas]
    act = [torch.as_tensor(x) for x in a["act"]]
    res = [torch.as_tensor(x) for x in a["res"]]
    pid = [torch.as_tensor(x) for x in a["pid"]]
    mig, defr, _ = partition._migrate_mega(ctxs, m, act, res, pid, per, [CPU] * S_, cap_out)
    rres = np.asarray(jo[2])
    np.testing.assert_array_equal(np.stack([r.numpy() for r in res]), rres)
    np.testing.assert_array_equal(np.stack([x.numpy() for x in act]), np.asarray(jo[1]))
    np.testing.assert_array_equal(np.stack([x.numpy() for x in pid]), np.asarray(jo[3]))
    got = np.stack([x.numpy() for x in m])
    # the head and the row cache (JAX parks the pid halves in the spare columns 28:30)
    np.testing.assert_array_equal(got[rres][:, :28], np.asarray(jo[0])[rres][:, :28])
    assert int(mig) == int(np.asarray(jo[4]).sum()) > 0
    assert int(defr) == int(np.asarray(jo[5]).sum()) > 0


def test_settle_rounds_keep_arrivals_on_the_single_device_trajectory(monkeypatch):
    """Slabs of a 9^3 box are jagged (4 slabs cut cell layers), so the
    settle walk of an arrival can pause again at yet another slab.  The
    port migrates such lanes again before the advect (MegaShards' settle
    rounds): 4 shards then follow the single-device run under "rbg"
    exactly (float64: tet, active and pos bit for bit).  Without the rounds
    those lanes idle a cycle and part from it (JAX's rule instead reads
    them as dead and loses them)."""
    from cudaparticlesfoam_tpu_torch import build_grid_locator, locate_seeds

    nside, n = 9, 4000
    pts, tets, _ = tmesh.box_points_tets(nside, nside, nside)
    cen = pts[tets].mean(axis=1)
    r = cen[:, :2] - nside / 2.0
    u = np.zeros_like(cen)
    u[:, 0], u[:, 1] = -r[:, 1] * 1.2, r[:, 0] * 1.2
    tm = convert.to_mesh(tmesh.from_arrays_host(pts, tets, tet_vel=u, dtype=np.float64),
                         device=CPU)
    pos = torch.as_tensor(np.random.default_rng(1).uniform(0.3, nside - 0.3, (n, 3)))
    st = convert.to_state(pos, locate_seeds(tm, build_grid_locator(tm), pos),
                          dtype=torch.float64, device=CPU)
    cfg = StepConfig(dt=0.1, diffusion_coeff=1e-3, brownian_rng="rbg")
    ref = run_cycles(tm, st, cfg, 40)

    def partitioned():
        eng = ParticleEngine(tm, st, cfg, devices=4, strategy="partitioned",
                             log=lambda *a: None)
        eng.advance(40, cfg.dt)
        return eng.snapshot()

    got = partitioned()
    assert torch.equal(got.tet_id, ref.tet_id) and torch.equal(got.active, ref.active)
    assert torch.equal(got.pos, ref.pos)
    monkeypatch.setattr(partition, "SETTLE_ROUNDS", 0)
    lag = partitioned()
    assert lag.active.all()                                   # idled, not lost
    assert int((lag.tet_id != ref.tet_id).sum()) > 100
