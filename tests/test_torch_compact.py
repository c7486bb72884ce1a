"""PyTorch port, the block-compacted hop gather (``hop_compact=4``, K3): the
admission rule (``hop_admit_plain``, the plain version of the CUDA
``hop_admit_kernel``) against the JAX package's ``_compact_hop_rows`` with
``_kernel_src_c``, and the compacted stream stages (bary and convex)
against ``pre_rare_cycle_packed`` / ``convex_pre_rare_cycle_packed`` with
``hop_compact=4``, both in Pallas interpret mode; then the compacted cycle
against the uncompacted one after the rare stage.  Inputs are built once
with numpy from a seed and uploaded to both packages.

Tolerances: the admission and the pending sets are exact; float32 against
the Pallas kernels gives exact tet/active and pos/vel/disp within 2e-6
(Mosaic may contract mul+add into FMA, the plain version does not); the
port against itself is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused_pallas
import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import fused, fused_convex, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread

N, NSIDE = fused_pallas.PACK_LANES, 8


def _x32(fn):
    """Run ``fn`` with x64 off: the Pallas kernels are float32-only and the
    harness enables x64 globally."""
    if not jax.config.read("jax_enable_x64"):
        return fn()
    jax.config.update("jax_enable_x64", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", True)


def _payload(dtype, seed=0):
    """Box 8^3 with an outward swirl plus noise (hops, walls, corners), +x
    faces tagged as patch 1."""
    pts, tets, vv = tmesh.box_points_tets(NSIDE, NSIDE, NSIDE)
    c = pts[tets].mean(axis=1) - NSIDE / 2.0
    tv = c / NSIDE * 2.0 + np.stack([-c[:, 1], c[:, 0], 0 * c[:, 2]], 1) / NSIDE
    tv = tv + np.random.default_rng(seed).normal(scale=0.2, size=tv.shape)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=tv, vert_vel=vv, dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > NSIDE - 1e-6).astype(np.int32)
    return payload


def _meshes(payload, escape, convex=False):
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    if escape:
        jm = jmesh.set_boundary_escape(jm, [1])
        tm = tmesh.set_boundary_escape(tm, [1])
    if convex:
        jm, tm = jmesh.with_convex_rows(jm), cpt.with_convex_rows(tm)
    return jm, tm


def _lanes(tm, seed):
    """(pos, vel, tet, active, xi) of N lanes, from numpy."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0.05, NSIDE - 0.05, (N, 3)), dtype=tm.dtype)
    tet = cpt.locate_seeds(tm, cpt.build_grid_locator(tm), pos)
    vel = torch.as_tensor(rng.normal(size=(N, 3)), dtype=tm.dtype)
    act = torch.as_tensor(rng.uniform(size=N) > 0.05)
    xi = torch.as_tensor(rng.standard_normal((N, 3)), dtype=tm.dtype)
    return pos, vel, tet, act, xi


# ---------------------------------------------------------------------------
# 1. the admission rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.7])
@pytest.mark.parametrize("frac", [1.0, 0.3, 0.02])
def test_hop_admit_matches_compact_hop_rows(rate, frac):
    """Random crossing flags over 8192 lanes: the lanes the port admits are
    exactly the slots whose valid flag ``_compact_hop_rows`` sets, and each
    such slot holds the crosser's own neighbour row (what the port's lane
    loads itself)."""
    rng = np.random.default_rng(int(rate * 100 + frac * 10))
    crossers = rng.uniform(size=N) < rate
    nt = 96
    tab = np.arange(nt * 20, dtype=np.float32).reshape(nt, 20)
    idx = rng.integers(0, nt, N)

    def jax_slots():
        head = np.zeros((fused_pallas.HEAD_W, N), np.float32)
        head[fused_pallas.HIDX] = idx
        head[fused_pallas.HMV] = crossers
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            rows4 = fused_pallas._compact_hop_rows(
                jnp.asarray(tab), fused_pallas.to_grouped(jnp.asarray(head)), N, frac)
        return np.asarray(rows4).reshape(N, 32)     # lane 4i+q at row i, cols 32q..

    slots = _x32(jax_slots)
    want = slots[:, 20] > 0.5
    admit = torch.empty(N, dtype=torch.uint8)
    capb = fused.hop_capacity(N, frac)
    fused_cuda.hop_admit(torch.as_tensor(crossers.astype(np.uint8)), admit, capb=capb)
    got = admit.numpy().astype(bool)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(slots[got, :20], tab[idx[got]])
    groups = crossers.reshape(-1, 4).sum(axis=1)
    overflow = (groups >= 3).any() or (groups > 0).sum() > capb
    assert (got.sum() < crossers.sum()) == overflow
    if (groups > 0).sum() > capb:
        assert (got.reshape(-1, 4).sum(axis=1) > 0).sum() == capb


def test_hop_capacity_mirrors_jax():
    """capb = min(max(ceil(nb4 * frac / 1024) * 1024, 1024), nb4) with nb4
    from n padded to 8192 lanes, as the JAX packed path pads it."""
    assert fused.hop_capacity(8192, 1.0) == 2048
    assert fused.hop_capacity(8192, 0.5) == 1024
    assert fused.hop_capacity(8192, 0.02) == 1024
    assert fused.hop_capacity(1000, 0.9) == 2048      # padded to one 8192 block
    assert fused.hop_capacity(1_000_000, 0.45) == 113_664
    assert fused.hop_capacity(65_536, 0.02) == 1024
    assert fused.hop_capacity(0, 0.5) == 0


def test_hop_admit_ragged_and_wrapper_checks():
    """A lane count that is not a multiple of 4 (the last group is short),
    and the wrapper's refusals."""
    c = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1], dtype=torch.uint8)
    a = torch.empty_like(c)
    fused_cuda.hop_admit(c, a, capb=5)
    assert a.tolist() == [1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0]
    fused_cuda.hop_admit(c, a, capb=1)
    assert a.tolist() == [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    before = fused_cuda.hop_admit.launches
    with pytest.raises(TypeError):
        fused_cuda.hop_admit(c.bool(), a, capb=1)
    with pytest.raises(ValueError):
        fused_cuda.hop_admit(c, a[:5], capb=1)
    with pytest.raises(ValueError):
        fused_cuda.hop_admit(c, a, capb=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_cuda.hop_admit(c.to("meta"), a.to("meta"), capb=1)
    assert fused_cuda.hop_admit.launches == before    # CPU: plain, no launch


# ---------------------------------------------------------------------------
# 2. the compacted stream stages against the Pallas kernels
# ---------------------------------------------------------------------------


CASES = [(frac, esc) for frac in (1.0, 0.02) for esc in (False, True)]
IDS = [f"frac={f}-escape={int(e)}" for f, e in CASES]


def _port_bary(tm, m0, xi, cfg):
    m = m0.clone()
    crossers = torch.empty(N, dtype=torch.uint8)
    admit = torch.empty_like(crossers)
    pend = torch.empty_like(crossers)
    kw = fused.stream_kwargs(cfg, cfg.dt, m.dtype)
    fused_cuda.stream_crossers(tm.tet_row, m, xi, crossers, **kw)
    assert torch.equal(m, m0)                     # the flag stage writes no state
    fused_cuda.hop_admit(crossers, admit, capb=fused.hop_capacity(N, cfg.hop_compact_frac))
    fused_cuda.stream_cycle(tm.tet_row, m, xi, pend, bounce_on=True, esc_on=cfg.escape_faces,
                            n_hops=1, admit=admit, **kw)
    return m, pend, crossers, admit


@pytest.mark.parametrize("frac,escape", CASES, ids=IDS)
def test_compacted_stream_matches_pallas_interpret(frac, escape):
    """Box 8^3, 8192 lanes, float32, one inline hop, noise injected: the
    crossing flags + hop_admit + the apply stage against
    ``pre_rare_cycle_packed`` with ``hop_compact=4`` (``_kernel_b_packed_c``).
    frac 1.0 overflows only by rank (third and fourth crossers of a group),
    0.02 also by capacity (1024 of the 2048 groups)."""
    jm, tm = _meshes(_payload(np.float32, seed=1), escape)
    pos, vel, tet, act, xi = _lanes(tm, seed=3 + escape)
    m0 = fused.pack_state(tm, pos, vel, tet, act)
    kw = dict(dt=0.15, diffusion_coeff=5e-3, hop_compact=4, hop_compact_frac=frac,
              escape_faces=escape)
    m, pend, crossers, admit = _port_bary(tm, m0, xi, cpt.StepConfig(**kw))

    def jax_cycle():
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            m_rm, jpend = fused_pallas.pre_rare_cycle_packed(
                jm, jm.tet_row, jnp.asarray(m0.numpy()).reshape(-1, 128),
                jax.random.PRNGKey(0), 3, JStepConfig(**kw), jnp.float32(kw["dt"]),
                noise=jnp.asarray(xi.numpy()), n_hops=1)
        return np.asarray(m_rm).reshape(N, 32), np.asarray(jpend)

    mj, jpend = _x32(jax_cycle)
    got = m.numpy()
    np.testing.assert_array_equal(pend.numpy().astype(bool), jpend)
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=2e-6, rtol=0)
    skipped = (crossers > 0) & (admit == 0)
    assert skipped.any() and pend.numpy()[skipped.numpy()].all()
    groups = crossers.view(-1, 4).sum(dim=1)
    if frac < 0.5:
        assert int((groups > 0).sum()) > 1024       # capacity overflow
    else:
        assert int((groups >= 3).sum()) > 0          # rank overflow
    if escape:
        assert ((got[:, 7] == 0) & (m0.numpy()[:, 7] == 1)).any()


@pytest.mark.parametrize("frac,escape", CASES, ids=IDS)
def test_convex_compacted_stream_matches_pallas_interpret(frac, escape):
    """The convex twin: crossing flags (CINT) + hop_admit + the apply stage
    against ``convex_pre_rare_cycle_packed`` with ``hop_compact=4``
    (``_kernel_cb_packed_c``), noise injected; pending, tet/active exact,
    pos/vel/disp within 2e-6."""
    jm, tm = _meshes(_payload(np.float32, seed=2), escape, convex=True)
    tab = fused_convex.cx_table(tm)
    pos, vel, tet, act, xi = _lanes(tm, seed=7 + escape)
    m0 = fused_convex.pack_state(tm, tab, pos, vel, tet, act)
    kw = dict(dt=0.4, diffusion_coeff=3e-3, locate_mode="convex", hop_compact=4,
              hop_compact_frac=frac, escape_faces=escape)
    cfg = cpt.StepConfig(**kw)
    skw = fused.stream_kwargs(cfg, cfg.dt, torch.float32)
    m = m0.clone()
    crossers = torch.empty(N, dtype=torch.uint8)
    admit, pend = torch.empty_like(crossers), torch.empty_like(crossers)
    disp = torch.empty((N, 3))
    fused_cuda.convex_stream_crossers(tab, m, xi, crossers, **skw)
    assert torch.equal(m, m0)
    fused_cuda.hop_admit(crossers, admit, capb=fused.hop_capacity(N, frac))
    fused_cuda.convex_stream_cycle(tab, m, xi, pend, disp, n_hops=1, admit=admit, **skw)

    def jax_cycle():
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            m_rm, disp_pk, jpend = fused_pallas.convex_pre_rare_cycle_packed(
                jm, jm.tet_row_cxe, jnp.asarray(m0.numpy()).reshape(-1, 128),
                jax.random.PRNGKey(0), 3, JStepConfig(**kw), jnp.float32(kw["dt"]),
                noise=jnp.asarray(xi.numpy()))
        return (np.asarray(m_rm).reshape(N, 32), np.asarray(disp_pk).reshape(N, 4)[:, :3],
                np.asarray(jpend))

    mj, dj, jpend = _x32(jax_cycle)
    got = m.numpy()
    np.testing.assert_array_equal(pend.numpy().astype(bool), jpend)
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=2e-6, rtol=0)
    np.testing.assert_allclose(disp.numpy(), dj, atol=2e-6, rtol=0)
    skipped = (crossers > 0) & (admit == 0)
    assert skipped.any() and pend.numpy()[skipped.numpy()].all()
    if frac < 0.5:
        assert int((crossers.view(-1, 4).sum(dim=1) > 0).sum()) > 1024


# ---------------------------------------------------------------------------
# 3. the compacted cycle ends where the uncompacted one does
# ---------------------------------------------------------------------------


END_CASES = [dict(), dict(locate_mode="convex", escape_faces=False),
             dict(locate_mode="convex", convex_bary_fix=False)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", range(len(END_CASES)))
def test_compacted_cycles_equal_uncompacted(dtype, case):
    """Five cycles of ``run_cycles`` with hop_compact=4 at frac 0.02 and 1.0
    against hop_compact=0: identical state after the rare stage (a skipped
    crosser walks, or is traced, from its pre-hop tet to the same end).
    Not in the convex mode with escape faces and ``convex_bary_fix``: its
    safety net can park an absorbed lane beyond the outlet face with a live
    tet, the next cycle's leak guard makes it a crosser, and there the
    inline hop and the rare tracer disagree, in JAX as here."""
    kw = dict(dict(dt=0.3, diffusion_coeff=5e-3, escape_faces=True), **END_CASES[case])
    _, tm = _meshes(_payload(dtype, seed=4), kw["escape_faces"],
                    convex="locate_mode" in kw)
    pos, vel, tet, act, _ = _lanes(tm, seed=11)
    st = convert.to_state(pos.numpy(), tet.numpy(), vel=vel.numpy(), active=act.numpy(),
                          dtype=dtype, device=CPU)
    cfg = cpt.StepConfig(**kw)
    want = cpt.run_cycles(tm, st, cfg, 5)
    for frac in (0.02, 1.0):
        got = cpt.run_cycles(tm, st, dataclasses.replace(cfg, hop_compact=4,
                                                         hop_compact_frac=frac), 5)
        for f in ("pos", "vel", "tet_id", "active"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (frac, f)
    assert (want.tet_id != tet).float().mean() > 0.5


# ---------------------------------------------------------------------------
# 4. the admission rule at small and ragged lane counts, with a shared scratch
# ---------------------------------------------------------------------------


def _admit_reference(crossers, capb):
    """The rule, lane by lane: groups of 4 in order, the first ``capb``
    groups that hold a crosser admitted, their first two crossers valid."""
    out = np.zeros(len(crossers), np.uint8)
    taken = 0
    for g in range(0, len(crossers), 4):
        lanes = [l for l in range(g, min(g + 4, len(crossers))) if crossers[l]]
        if lanes:
            if taken < capb:
                out[lanes[:2]] = 1
            taken += 1
    return out


@pytest.mark.parametrize("capb", ["none", "some", "all"])
@pytest.mark.parametrize("n", [1, 3, 15, 17, 4099])
def test_hop_admit_small_and_ragged_lane_counts(n, capb):
    """n = 1, 3, 15, 17 and 4,099 (no multiple of 4 or of 16), capacity 0,
    a third of the groups, and more than the groups; no flag, every flag
    and random flags; one scratch buffer, sized for the largest n, passed to
    every call and left as it was."""
    groups = -(-n // 4)
    cap = {"none": 0, "some": groups // 3, "all": groups + 5}[capb]
    scratch = fused_cuda.hop_admit_scratch(4099, CPU)
    rng = np.random.default_rng(n)
    for flags in (np.zeros(n, np.uint8), np.ones(n, np.uint8),
                  (rng.uniform(size=n) < 0.4).astype(np.uint8)):
        admit = torch.full((n,), 7, dtype=torch.uint8)
        fused_cuda.hop_admit(torch.as_tensor(flags), admit, capb=cap, scratch=scratch)
        np.testing.assert_array_equal(admit.numpy(), _admit_reference(flags, cap))
    assert int(scratch.abs().sum()) == 0


def test_hop_admit_scratch_size_and_refusals():
    """The scratch holds 2 words and one per tile of 8192 lanes; a smaller
    one, another type or another shape is refused before anything runs."""
    assert fused_cuda.hop_admit_scratch(1, CPU).shape == (3,)
    assert fused_cuda.hop_admit_scratch(8192, CPU).shape == (3,)
    assert fused_cuda.hop_admit_scratch(8193, CPU).shape == (4,)
    assert fused_cuda.hop_admit_scratch(1_000_000, CPU).shape == (125,)
    assert fused_cuda.hop_admit_scratch(100, CPU).dtype == torch.int32
    c = torch.ones(20_000, dtype=torch.uint8)
    a = torch.empty_like(c)
    fused_cuda.hop_admit(c, a, capb=10, scratch=fused_cuda.hop_admit_scratch(20_000, CPU))
    assert int(a.sum()) == 20
    with pytest.raises(ValueError, match="scratch"):
        fused_cuda.hop_admit(c, a, capb=10, scratch=fused_cuda.hop_admit_scratch(8192, CPU))
    with pytest.raises(TypeError):
        fused_cuda.hop_admit(c, a, capb=10, scratch=torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="scratch"):
        fused_cuda.hop_admit(c, a, capb=10, scratch=torch.zeros((2, 4), dtype=torch.int32))
