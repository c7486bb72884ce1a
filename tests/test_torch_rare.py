"""PyTorch port: the rare stage (``rare_plain``, the plain version of the
CUDA ``rare_kernel``) against the JAX package's ``fused._rare_stage`` on
identical (mega, pending) inputs in float64: tet/active exact, pos/vel
within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu.mesh as jmesh
from cudaparticlesfoam_tpu import StepConfig as JStepConfig
from cudaparticlesfoam_tpu.ops import fused as jfused
from cudaparticlesfoam_tpu_torch import (StepConfig, build_grid_locator, convert, locate_seeds,
                                         with_convex_rows, with_pk_rows)
from cudaparticlesfoam_tpu_torch import mesh as tmesh
from cudaparticlesfoam_tpu_torch.ops import fused, fused_convex, fused_cuda

from torch_port_common import CPU   # also caps torch at one thread

NSIDE, N = 6, 2048


def _meshes(escape):
    pts, tets, vv = tmesh.box_points_tets(NSIDE, NSIDE, NSIDE)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1),
                                     vert_vel=vv, dtype=np.float64)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = ((ctr[:, 0] > NSIDE - 1e-6) | (ctr[:, 1] < 1e-6)).astype(np.int32)
    jm = jmesh.host_to_device(dict(payload))
    tm = convert.to_mesh(payload, device=CPU)
    if escape:
        jm = jmesh.set_boundary_escape(jm, [1])
        tm = tmesh.set_boundary_escape(tm, [1])
    return jm, tm


def _rare_inputs(tm, kind, seed):
    """Lanes with a cached start tet and a far target position in the pos
    columns: 'walk' = 0-4 cells away (multi-hop walkers, some past a wall),
    'corner' = targets beyond the box corners (multi-bounce hits)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.2, NSIDE - 0.2, (N, 3))
    st = convert.to_state(start, np.zeros(N, np.int32), dtype=torch.float64, device=CPU)
    tet = locate_seeds(tm, build_grid_locator(tm), st.pos)
    if kind == "walk":
        target = start + rng.normal(scale=1.6, size=(N, 3))
    else:
        corner = rng.integers(0, 2, (N, 3)) * NSIDE
        target = corner + np.where(corner > 0, 1.0, -1.0) * rng.uniform(0.01, 1.5, (N, 3))
    vel = torch.as_tensor(rng.normal(size=(N, 3)))
    act = torch.as_tensor(rng.uniform(size=N) > 0.02)
    m = fused.pack_state(fused.row_table(tm), torch.as_tensor(target), vel, tet, act)
    pend = torch.as_tensor(rng.uniform(size=N) < 0.7).to(torch.uint8)
    return m, pend


CASES = [
    ("walk", dict()),
    ("corner", dict()),
    ("walk", dict(escape_faces=True)),
    ("corner", dict(escape_faces=True)),
    ("walk", dict(reflect_wall=False)),
    ("walk", dict(max_hops=1)),
    ("corner", dict(max_bounces=1)),
    ("corner", dict(max_hops=3, max_bounces=3, walk_capacity_frac=0.01)),
    ("corner", dict(max_bounces=0)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rare_plain_matches_jax_rare_stage(case):
    kind, kw = CASES[case]
    escape = kw.get("escape_faces", False)
    jm, tm = _meshes(escape)
    m0, pend = _rare_inputs(tm, kind, seed=case)
    cfg = StepConfig(**kw)
    m = m0.clone()
    fused_cuda.rare_resolve(tm.tet_row, m, pend, tm.bd_escape, max_hops=cfg.max_hops,
                            max_bounces=cfg.max_bounces, reflect_wall=cfg.reflect_wall)
    mj = np.asarray(jfused._rare_stage(
        jm, jm.tet_row, jnp.asarray(m0.numpy()), jnp.asarray(pend.numpy().astype(bool)),
        JStepConfig(**kw), jfused.LAYOUT_TET, N, N // 8, 32))
    got = m.numpy()
    np.testing.assert_array_equal(got[:, 6], mj[:, 6])
    np.testing.assert_array_equal(got[:, 7], mj[:, 7])
    np.testing.assert_allclose(got[:, :6], mj[:, :6], atol=1e-12, rtol=0)
    # lanes not pending are untouched; the case really walked and bounced
    idle = pend.numpy() == 0
    np.testing.assert_array_equal(got[idle], m0.numpy()[idle])
    moved = (got[:, 6] != m0.numpy()[:, 6]) & ~idle
    assert moved.any()
    if kind == "corner" and cfg.reflect_wall and cfg.max_bounces:
        assert (np.abs(got[~idle, 3:6] - m0.numpy()[~idle, 3:6]) > 0).any()
    if escape:
        assert (got[~idle, 6] < 0).any()
    if cfg.reflect_wall and not escape:
        # out of bounces, a wall lane keeps its non-negative exit tet
        assert (got[~idle & (m0.numpy()[:, 6] >= 0), 6] >= 0).all()


def test_rare_plain_with_nothing_pending_is_a_no_op():
    _, tm = _meshes(False)
    m0, pend = _rare_inputs(tm, "walk", seed=0)
    m = m0.clone()
    fused.rare_plain(tm.tet_row, m, torch.zeros_like(pend), tm.bd_escape,
                     max_hops=50, max_bounces=10, reflect_wall=True)
    assert torch.equal(m, m0)


# ---------------------------------------------------------------------------
# the chain of dependent row loads of each pending lane (fused.rare_chain,
# fused_convex.rare_chain), against a scalar per-lane walk written here from
# csrc/rare.cu and csrc/convex_rare.cu: Python floats are IEEE doubles, and
# every expression keeps the plain versions' association order
# ---------------------------------------------------------------------------


def _port_mesh(escape, pk=False, convex=False):
    pts, tets, vv = tmesh.box_points_tets(NSIDE, NSIDE, NSIDE)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1),
                                     vert_vel=vv, dtype=np.float64)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = ((ctr[:, 0] > NSIDE - 1e-6) | (ctr[:, 1] < 1e-6)).astype(np.int32)
    tm = tmesh.set_boundary_escape(convert.to_mesh(payload, device=CPU), [1] if escape else [])
    if pk:
        tm = with_pk_rows(tm)
    if convex:
        tm = with_convex_rows(tm)
    return tm


def _bary(r, p):
    rx, ry, rz = p[0] - r[0], p[1] - r[1], p[2] - r[2]
    wb = r[3] * rx + r[4] * ry + r[5] * rz
    wc = r[6] * rx + r[7] * ry + r[8] * rz
    wd = r[9] * rx + r[10] * ry + r[11] * rz
    return [1.0 - wb - wc - wd, wb, wc, wd]


def _argmin(w):
    s, b = 0, w[0]
    for i in range(1, 4):
        if w[i] < b:
            s, b = i, w[i]
    return s, b


def _scalar_rare(tab, row, tet, p, v, esc, ly, max_hops, max_bounces, reflect_wall):
    """rare.cu's walk + reflect for one lane: (final tet, row loads)."""
    loads = 0

    def walk(row, tet, hops):
        nonlocal loads
        slot = 0
        if tet < 0:
            return row, tet, slot
        for _ in range(max(2, hops)):
            s, wmin = _argmin(_bary(row, p))
            if wmin >= 0.0:
                break
            code, slot = int(row[ly.nbr + s]), s
            if code < 0:
                return row, -(tet + 1), slot
            tet, row = code, tab[code]
            loads += 1
        return row, tet, slot

    row, tet, slot = walk(row, tet, max_hops)
    if reflect_wall and tet < 0:
        tet, s = -(tet + 1), slot
        for _ in range(max_bounces):
            code_nbr = int(row[ly.nbr + s])
            if code_nbr < 0 and len(esc) and esc[min(-code_nbr - 1, len(esc) - 1)]:
                tet = -(tet + 1)
                break
            g = [-(row[3 + o] + row[6 + o] + row[9 + o]) if s == 0 else row[3 * s + o]
                 for o in range(3)]
            wv = _bary(row, p)[s]
            inv_g2 = 1.0 / (g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
            f, fu = 2.0 * wv * inv_g2, 2.0 * (v[0] * g[0] + v[1] * g[1] + v[2] * g[2]) * inv_g2
            p[:] = [p[k] - f * g[k] for k in range(3)]
            v[:] = [v[k] - fu * g[k] for k in range(3)]
            row, wtet, s2 = walk(row, tet, 50)
            if wtet >= 0:
                tet = wtet
                break
            tet, s = -(wtet + 1), s2
    return tet, loads


def _chain_inputs(tm, ly, kind, seed):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.2, NSIDE - 0.2, (N, 3))
    st = convert.to_state(start, np.zeros(N, np.int32), dtype=torch.float64, device=CPU)
    tet = locate_seeds(tm, build_grid_locator(tm), st.pos)
    if kind == "walk":
        target = start + rng.normal(scale=1.6, size=(N, 3))
    else:
        corner = rng.integers(0, 2, (N, 3)) * NSIDE
        target = corner + np.where(corner > 0, 1.0, -1.0) * rng.uniform(0.01, 1.5, (N, 3))
    vel = torch.as_tensor(rng.normal(size=(N, 3)))
    m = fused.pack_state(fused.row_table(tm, ly), torch.as_tensor(target), vel, tet,
                         torch.ones(N, dtype=torch.bool), ly.width)
    return m, torch.as_tensor(rng.uniform(size=N) < 0.4).to(torch.uint8)


BARY_CHAIN_CASES = [(pk, esc, refl) for pk in (False, True) for esc in (False, True)
                    for refl in (True, False)]


@pytest.mark.parametrize("pk, escape, reflect_wall", BARY_CHAIN_CASES)
def test_rare_chain_matches_a_scalar_walk(pk, escape, reflect_wall):
    ly = fused.LAYOUT_PK if pk else fused.LAYOUT_TET
    tm = _port_mesh(escape, pk=pk)
    tab = fused.row_table(tm, ly)
    m, pend = _chain_inputs(tm, ly, "corner" if reflect_wall else "walk", seed=3 + pk)
    kw = dict(max_hops=4, max_bounces=10, reflect_wall=reflect_wall)
    chain = fused.rare_chain(tab, m, pend, tm.bd_escape, ly=ly, **kw)
    m_after = m.clone()
    fused.rare_plain(tab, m_after, pend, tm.bd_escape, ly=ly, **kw)
    idx = pend.nonzero()[:, 0]
    assert chain.dtype == torch.int64 and chain.shape == idx.shape
    tab_l, esc = tab.tolist(), tm.bd_escape.tolist()
    want, tets = [], []
    for i in idx.tolist():
        row = m[i, 8 : 8 + ly.tab_w].tolist()
        tet, loads = _scalar_rare(tab_l, row, int(m[i, 6]), m[i, 0:3].tolist(),
                                  m[i, 3:6].tolist(), esc, ly, reflect_wall=reflect_wall,
                                  **{k: kw[k] for k in ("max_hops", "max_bounces")})
        want.append(loads)
        tets.append(tet)
    assert chain.tolist() == want
    assert m_after[idx, 6].to(torch.int64).tolist() == tets
    assert int(chain.max()) >= 3 and float(chain.double().mean()) > 0.5
    if reflect_wall and escape:
        assert min(tets) < 0


@pytest.mark.parametrize("pk", [False, True])
def test_rare_plain_same_m_with_and_without_counting(pk):
    ly = fused.LAYOUT_PK if pk else fused.LAYOUT_TET
    tm = _port_mesh(True, pk=pk)
    tab = fused.row_table(tm, ly)
    m0, pend = _chain_inputs(tm, ly, "corner", seed=5)
    kw = dict(max_hops=50, max_bounces=10, reflect_wall=True, ly=ly)
    a, b = m0.clone(), m0.clone()
    fused.rare_plain(tab, a, pend, tm.bd_escape, **kw)
    chain = torch.zeros(int(pend.sum()), dtype=torch.int64)
    fused.rare_plain(tab, b, pend, tm.bd_escape, chain=chain, **kw)
    assert torch.equal(a, b) and not torch.equal(a, m0)
    m1 = m0.clone()
    assert torch.equal(fused.rare_chain(tab, m1, pend, tm.bd_escape, **kw), chain)
    assert torch.equal(m1, m0)          # rare_chain leaves m alone
    none = fused.rare_chain(tab, m0, torch.zeros_like(pend), tm.bd_escape, **kw)
    assert none.shape == (0,) and none.dtype == torch.int64


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _div(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(a) / np.float64(b))


class _ScalarConvex:
    """convex_rare.cu's trace, convex_reflect, bary_walk and reflect_walls
    for one lane at a time, counting the dependent row loads."""

    def __init__(self, tm):
        self.cx = tm.tet_row_cx.tolist()
        self.a, self.tinv = tm.tet_a.tolist(), tm.tet_tinv.reshape(-1, 9).tolist()
        self.nbr = tm.tet_nbr.tolist()
        self.fn, self.fd = tm.tet_face_n.reshape(-1, 12).tolist(), tm.tet_face_d.tolist()
        self.esc = tm.bd_escape.tolist()
        self.loads = 0

    def trace(self, pos, disp, tet_id, max_tets):
        pe = [pos[k] + disp[k] for k in range(3)]
        p0, tet, inlet, wall = list(pos), max(tet_id, 0), -2, False
        if tet_id >= 0:
            for _ in range(max_tets):
                self.loads += 1
                seg = [pe[k] - p0[k] for k in range(3)]
                r = self.cx[tet]
                bdt, slot = 1.1, -1
                for f in range(4):
                    nf = r[3 * f : 3 * f + 3]
                    face_dist = _dot3(nf, p0) - r[12 + f]
                    dt_ = _div(face_dist, -_dot3(nf, seg))
                    if np.isinf(dt_):
                        dt_ = -1.0
                    ok = (face_dist < 1e-13 and dt_ > 1e-13 and dt_ <= 1.0
                          and int(r[20 + f]) != inlet)
                    if (dt_ if ok else 1.1) < bdt:
                        bdt, slot = dt_, f
                if slot < 0:
                    break
                nxt, fid = int(r[16 + slot]), int(r[20 + slot])
                p0 = [p0[k] + bdt * seg[k] for k in range(3)]
                inlet = fid
                if nxt < 0:
                    wall = True
                    break
                tet = nxt
        code = tet_id if tet_id < 0 else (-(tet_id + 1) if wall else tet)
        return code, tet, p0, inlet

    def face_slot(self, tet, p, fid):
        r = self.cx[max(tet, 0)]
        slot, best = 0, 0.0
        for f in range(4):
            if int(r[20 + f]) == fid:
                score = -1.0
            elif int(r[16 + f]) < 0:
                score = abs(r[12 + f] - _dot3(r[3 * f : 3 * f + 3], p))
            else:
                score = float("inf")
            if f == 0 or score < best:
                slot, best = f, score
        return slot

    def escapes_at(self, tet, p, fid):
        if not self.esc:
            return False
        code = int(self.cx[max(tet, 0)][16 + self.face_slot(tet, p, fid)])
        return code < 0 and self.esc[min(max(-code - 1, 0), len(self.esc) - 1)]

    def mirror(self, p_end, u, tet, p_at, fid):
        r = self.cx[max(tet, 0)]
        s = self.face_slot(tet, p_at, fid)
        n = r[3 * s : 3 * s + 3]
        fp, fu = 2.0 * (_dot3(p_end, n) - r[12 + s]), 2.0 * _dot3(u, n)
        return [p_end[k] - fp * n[k] for k in range(3)], [u[k] - fu * n[k] for k in range(3)]

    def reflect(self, pos, disp, vel, code, stop_tet, p_cross, hit_face):
        if code >= 0:
            return pos, disp, vel, code
        p_end = [pos[k] + disp[k] for k in range(3)]
        u, p_hit, p_start, tet = list(vel), list(p_cross), list(p_cross), stop_tet
        esc = self.escapes_at(tet, p_cross, hit_face)
        if not esc:
            p_end, u = self.mirror(p_end, u, tet, p_cross, hit_face)
            for _ in range(5):
                d = [p_end[k] - p_start[k] for k in range(3)]
                c2, s_tet, p_cr, l_face = self.trace(p_start, d, max(tet, 0), 50)
                if c2 >= 0:
                    tet = c2
                    break
                tet, p_hit = s_tet, p_cr
                if self.escapes_at(s_tet, p_cr, l_face):
                    esc = True
                    break
                p_start = p_cr
                p_end, u = self.mirror(p_end, u, tet, p_cr, l_face)
        disp = [0.0] * 3 if esc else [p_end[k] - p_hit[k] for k in range(3)]
        return p_hit, disp, u, (code if esc else tet)

    def walk(self, p, tet, max_hops=50):
        slot = -1
        if tet < 0:
            return tet, slot
        for _ in range(max_hops):
            self.loads += 1
            a, t = self.a[tet], self.tinv[tet]
            rel = [p[k] - a[k] for k in range(3)]
            w = [t[3 * k] * rel[0] + t[3 * k + 1] * rel[1] + t[3 * k + 2] * rel[2]
                 for k in range(3)]
            s, wmin = _argmin([1.0 - ((w[0] + w[1]) + w[2])] + w)
            if wmin >= 0.0:
                return tet, slot
            self.loads += 1
            nb, slot = self.nbr[tet][s], s
            if nb < 0:
                return -(tet + 1), slot
            tet = nb
        return tet, slot

    def reflect_walls(self, p_land, d2, vel, tet_id, max_bounces):
        if tet_id < 0:
            tet_bd, u, p_ref = -(tet_id + 1), list(vel), [p_land[k] + 0.0 for k in range(3)]
            for _ in range(max_bounces):
                wtet, wslot = self.walk(p_ref, tet_bd)
                if wtet >= 0:
                    tet_bd = wtet
                    break
                ex_tet, ex_slot = -(wtet + 1), max(wslot, 0)
                code_nbr = self.nbr[ex_tet][ex_slot]
                if self.esc and code_nbr < 0 and self.esc[min(-code_nbr - 1, len(self.esc) - 1)]:
                    tet_bd = -(ex_tet + 1)
                    break
                self.loads += 1
                n = self.fn[ex_tet][3 * ex_slot : 3 * ex_slot + 3]
                fp = 2.0 * (((p_ref[0] * n[0] + p_ref[1] * n[1]) + p_ref[2] * n[2])
                            - self.fd[ex_tet][ex_slot])
                fu = 2.0 * ((u[0] * n[0] + u[1] * n[1]) + u[2] * n[2])
                p_ref = [p_ref[k] - fp * n[k] for k in range(3)]
                u = [u[k] - fu * n[k] for k in range(3)]
                tet_bd = ex_tet
            vel = u
            tet_id = tet_bd
        return tet_id, vel

    def lane(self, pos, vel, d, tet, max_hops, reflect_wall, bary_fix, max_bounces):
        self.loads = 0
        code, stop_tet, p_cross, hit_face = self.trace(pos, d, tet, max_hops)
        if reflect_wall:
            pos, d, vel, code = self.reflect(pos, d, vel, code, stop_tet, p_cross, hit_face)
            if bary_fix:
                p_land = [pos[k] + d[k] for k in range(3)]
                tet_chk, _ = self.walk(p_land, code)
                code, vel = self.reflect_walls(p_land, d, vel, tet_chk, max_bounces)
        return code, self.loads + 1      # + the refreshed cx_table row


CONVEX_CHAIN_CASES = [(False, True, True), (True, True, True), (True, True, False),
                      (False, False, False)]


@pytest.mark.parametrize("escape, reflect_wall, bary_fix", CONVEX_CHAIN_CASES)
def test_convex_rare_chain_matches_a_scalar_walk(escape, reflect_wall, bary_fix):
    tm = _port_mesh(escape, convex=True)
    tab = fused_convex.cx_table(tm)
    rng = np.random.default_rng(11 + escape)
    start = rng.uniform(0.2, NSIDE - 0.2, (N, 3))
    st = convert.to_state(start, np.zeros(N, np.int32), dtype=torch.float64, device=CPU)
    tet = locate_seeds(tm, build_grid_locator(tm), st.pos)
    vel = torch.as_tensor(rng.normal(size=(N, 3)))
    m = fused.pack_state(tab, st.pos, vel, tet, torch.ones(N, dtype=torch.bool), fused_convex.WIDTH)
    disp = torch.as_tensor(rng.normal(scale=2.0, size=(N, 3)))
    pend = torch.as_tensor(rng.uniform(size=N) < 0.4).to(torch.uint8)
    kw = dict(max_hops=50, reflect_wall=reflect_wall, bary_fix=bary_fix, max_bounces=10)
    chain = fused_convex.rare_chain(tm, tab, m, disp, pend, **kw)
    m_after = m.clone()
    fused_convex.convex_rare_plain(tm, tab, m_after, disp, pend, **kw)
    sc = _ScalarConvex(tm)
    idx = pend.nonzero()[:, 0]
    want, codes = [], []
    for i in idx.tolist():
        code, loads = sc.lane(m[i, 0:3].tolist(), m[i, 3:6].tolist(), disp[i].tolist(),
                              int(m[i, 6]), **kw)
        want.append(loads)
        codes.append(code)
    assert chain.dtype == torch.int64 and chain.tolist() == want
    assert m_after[idx, 6].to(torch.int64).tolist() == codes
    assert int(chain.max()) >= 5
    if reflect_wall:
        assert min(codes) < 0 if escape else min(codes) >= 0


def test_convex_rare_plain_same_m_with_and_without_counting():
    tm = _port_mesh(True, convex=True)
    tab = fused_convex.cx_table(tm)
    rng = np.random.default_rng(2)
    start = torch.as_tensor(rng.uniform(0.2, NSIDE - 0.2, (N, 3)))
    tet = locate_seeds(tm, build_grid_locator(tm), start)
    m0 = fused.pack_state(tab, start, torch.as_tensor(rng.normal(size=(N, 3))), tet,
                          torch.ones(N, dtype=torch.bool), fused_convex.WIDTH)
    disp = torch.as_tensor(rng.normal(scale=2.0, size=(N, 3)))
    pend = torch.as_tensor(rng.uniform(size=N) < 0.5).to(torch.uint8)
    kw = dict(max_hops=50, reflect_wall=True, bary_fix=True, max_bounces=10)
    a, b = m0.clone(), m0.clone()
    fused_convex.convex_rare_plain(tm, tab, a, disp, pend, **kw)
    chain = torch.zeros(int(pend.sum()), dtype=torch.int64)
    fused_convex.convex_rare_plain(tm, tab, b, disp, pend, chain=chain, **kw)
    assert torch.equal(a, b) and not torch.equal(a, m0)
    m1 = m0.clone()
    assert torch.equal(fused_convex.rare_chain(tm, tab, m1, disp, pend, **kw), chain)
    assert torch.equal(m1, m0)
