"""Convex face-crossing locator and reflector, the "ConvexPoly" mode (port
of ``cudaparticlesfoam_tpu/ops/convex.py``).

* :func:`trace_segment` == ``traceIntet`` + ``particleLocator``
  (``ConvexQuery.cu:32-216``): march the segment P -> P+disp through tets;
  in each tet the exit face has ``face_dist < tol``, ``tol < dT <= 1`` and
  minimal dT (tol 1e-13), the inlet face skipped; at most ``max_tets``
  tets; a wall hit stops at the hit point with code ``-(startTet+1)``.
* :func:`convex_reflect` == ``convexReflector``/``reflectInTet``
  (``ConvexQuery.cu:239-436``): mirror the rest of the segment and the
  velocity across the hit face, re-trace (default 50 tets), at most 5
  bounces; absorbing faces (``bd_escape``) park the lane at the hit point
  with its wall code and no displacement.

Plain torch on any device.  The JAX ``while_loop``s are Python loops with
the same bounds: every loop freezes its finished lanes, so running them in
lockstep equals running each lane on its own (what ``csrc/convex_rare.cu``
does).  Sums over xyz keep jnp's order ((x0 + x1) + x2).
"""

from __future__ import annotations

import torch

from ..mesh import TetMesh

TOL = 1e-13      # ConvexQuery.cu:42
MAX_TETS = 50    # ConvexQuery.cu:169
MAX_BOUNCES = 5  # ConvexQuery.cu:353


def _dot3(a, b):
    """sum(a * b, -1) over a last axis of 3, as jnp.sum associates it."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _tet_tables(mesh: TetMesh, safe):
    """(normals [c,4,3], offsets [c,4], nbr [c,4] int64, face ids [c,4]
    int64) of tets ``safe``: one row gather from ``tet_row_cx`` when the
    mesh has it, else four."""
    if mesh.tet_row_cx is not None:
        row = mesh.tet_row_cx[safe]
        return (row[:, 0:12].reshape(-1, 4, 3), row[:, 12:16],
                row[:, 16:20].to(torch.int64), row[:, 20:24].to(torch.int64))
    return (mesh.tet_face_n[safe], mesh.tet_face_d[safe],
            mesh.tet_nbr[safe].to(torch.int64), mesh.tet_faces[safe].to(torch.int64))


def _first_min(score):
    """First-minimum argmin over the last axis of [c, 4] (strict '<')."""
    best = score[:, 0]
    slot = torch.zeros(score.shape[0], dtype=torch.int64, device=score.device)
    for i in range(1, score.shape[1]):
        upd = score[:, i] < best
        best = torch.where(upd, score[:, i], best)
        slot = torch.where(upd, torch.full_like(slot, i), slot)
    return slot


def _exit_face_tables(n, d, p0, seg, suppress):
    """Core of one ``traceIntet`` on per-lane tables: (dT, slot) of the
    admitted exit face with minimal dT (scan order, strict '<'); slot -1
    when the segment ends inside.  ``suppress`` [c, 4] bool excludes faces
    (the inlet-face skip)."""
    T = p0.dtype
    tol = torch.tensor(TOL, dtype=T, device=p0.device)
    face_dist = _dot3(n, p0[:, None, :]) - d
    denom = -_dot3(n, seg[:, None, :])
    dt_ = face_dist / denom
    dt_ = torch.where(torch.isinf(dt_), torch.full_like(dt_, -1.0), dt_)   # parallel
    ok = (face_dist < tol) & (dt_ > tol) & (dt_ <= 1.0) & ~suppress
    dt_masked = torch.where(ok, dt_, torch.full_like(dt_, 1.1))
    best_dt = torch.full((p0.shape[0],), 1.1, dtype=T, device=p0.device)
    best_slot = torch.full((p0.shape[0],), -1, dtype=torch.int64, device=p0.device)
    for i in range(4):
        upd = dt_masked[:, i] < best_dt
        best_dt = torch.where(upd, dt_masked[:, i], best_dt)
        best_slot = torch.where(upd, torch.full_like(best_slot, i), best_slot)
    return best_dt, best_slot


def _pick(cols, slot):
    return cols.gather(1, slot[:, None])[:, 0]


def _exit_face(mesh: TetMesh, p0, seg, tet, inlet_face):
    """One ``traceIntet``: (dT, slot, next code, face id) for p0 -> p0+seg
    leaving ``tet``; slot -1 when the segment ends inside."""
    n, d, nbr, fids = _tet_tables(mesh, tet.clamp(min=0))
    best_dt, best_slot = _exit_face_tables(n, d, p0, seg, fids == inlet_face[:, None])
    hit = best_slot >= 0
    slot_safe = best_slot.clamp(min=0)
    return (best_dt, best_slot, torch.where(hit, _pick(nbr, slot_safe), tet),
            torch.where(hit, _pick(fids, slot_safe), torch.full_like(tet, -2)))


def trace_segment(mesh: TetMesh, pos, disp, tet_id, active=None,
                  max_tets: int = MAX_TETS, chain=None):
    """Vectorized ``particleLocator``.  Returns (code, stop_tet, p_cross,
    last_face): ``code`` = final hosting tet or ``-(startTet+1)`` on a wall
    hit; ``stop_tet`` = the tet the march stopped in; ``p_cross`` = the
    march point (the hit point for wall lanes); ``last_face`` = the id of
    the last crossed face (-2 if none).  Integer outputs are int64.
    ``chain`` (int64, one per lane): adds the cx rows each lane traced."""
    n = pos.shape[0]
    tet_id = tet_id.to(torch.int64)
    p_end = pos + disp
    act = torch.ones(n, dtype=torch.bool, device=pos.device) if active is None else active
    live0 = act & (tet_id >= 0)
    p0 = pos
    tet = tet_id.clamp(min=0)
    inlet = torch.full_like(tet_id, -2)
    done = ~live0
    hit_wall = torch.zeros_like(done)
    for _ in range(max_tets):
        if bool(done.all()):
            break
        if chain is not None:
            chain += ~done
        seg = p_end - p0
        dt_, slot, nxt, fid = _exit_face(mesh, p0, seg, tet, inlet)
        crossing = ~done & (slot >= 0)
        inside = ~done & (slot < 0)
        p0 = torch.where(crossing[:, None], p0 + dt_[:, None] * seg, p0)
        wall = crossing & (nxt < 0)
        tet = torch.where(crossing & ~wall, nxt, tet)
        inlet = torch.where(crossing, fid, inlet)
        done = done | inside | wall
        hit_wall = hit_wall | wall
    code = torch.where(hit_wall, -(tet_id + 1), tet)
    code = torch.where(live0, code, tet_id)
    return code, tet, p0, inlet


def _face_slot(mesh: TetMesh, tet, p_at, fid):
    """(tables, slot) of the face that ended a trace: the face whose id is
    ``fid``, else the nearest boundary plane (first minimum of match -> -1,
    boundary -> distance, else inf)."""
    nrm, dpl, nbr, fids = _tet_tables(mesh, tet.clamp(min=0))
    match = fids == fid[:, None]
    dist = (dpl - _dot3(nrm, p_at[:, None, :])).abs()
    inf = torch.full_like(dist, float("inf"))
    score = torch.where(match, torch.full_like(dist, -1.0),
                        torch.where(nbr < 0, dist, inf))
    return (nrm, dpl, nbr), _first_min(score)


def _hit_face_plane(mesh: TetMesh, stop_tet, p_cross, last_face):
    """Outward plane (n [c,3], d [c]) of the face that ended the trace."""
    (nrm, dpl, _), slot = _face_slot(mesh, stop_tet, p_cross, last_face)
    return nrm[torch.arange(slot.shape[0], device=slot.device), slot], _pick(dpl, slot)


def _escapes_at(mesh: TetMesh, tet, p_at, fid, lanes):
    """True for ``lanes`` whose hit face (matched as in
    :func:`_hit_face_plane`) is an absorbing boundary face."""
    nbd = mesh.n_bd_faces
    if nbd == 0:
        return torch.zeros_like(lanes)
    (_, _, nbr), slot = _face_slot(mesh, tet, p_at, fid)
    code = _pick(nbr, slot)
    bd = (-code - 1).clamp(0, nbd - 1)
    return lanes & (code < 0) & mesh.bd_escape[bd]


def _mirror(mesh, p_end, u, tet, p_at, fid, refl):
    nsel, dsel = _hit_face_plane(mesh, tet, p_at, fid)
    pe = p_end - 2.0 * (_dot3(p_end, nsel) - dsel)[:, None] * nsel
    un = u - 2.0 * _dot3(u, nsel)[:, None] * nsel
    return (torch.where(refl[:, None], pe, p_end), torch.where(refl[:, None], un, u))


def convex_reflect(mesh: TetMesh, pos, disp, vel, tet_id, stop_tet, p_cross,
                   hit_face, max_bounces: int = MAX_BOUNCES, chain=None):
    """Vectorized ``convexReflector`` for wall-hit lanes (tet_id < 0).
    Absorbing faces keep the negative wall code, park the lane at the hit
    point and drop its displacement.  Every re-trace uses the default
    ``MAX_TETS``.  Returns (pos, disp, vel, tet_id).  ``chain``: adds the
    re-traces' cx rows (the face matching and the mirror read the row the
    trace ended in)."""
    tet_id = tet_id.to(torch.int64)
    hit = tet_id < 0
    p_end = pos + disp
    u = vel
    p_hit = torch.where(hit[:, None], p_cross, pos)
    p_start = p_hit
    tet = torch.where(hit, stop_tet.to(torch.int64), tet_id.clamp(min=0))
    esc = _escapes_at(mesh, tet, p_cross, hit_face, hit)
    settled = ~hit | esc
    # first bounce: mirror across the face found by the main trace
    p_end, u = _mirror(mesh, p_end, u, tet, p_cross, hit_face, ~settled)
    for _ in range(max_bounces):
        if bool(settled.all()):
            break
        refl = ~settled
        code, s_tet, p_cr, l_face = trace_segment(mesh, p_start, p_end - p_start,
                                                  tet.clamp(min=0), active=refl, chain=chain)
        landed = refl & (code >= 0)
        tet = torch.where(landed, code, torch.where(refl, s_tet, tet))
        settled = settled | landed
        refl = refl & ~landed
        # still hitting a wall: absorb on escape faces, else mirror again
        new_esc = _escapes_at(mesh, torch.where(refl, s_tet, tet), p_cr, l_face, refl)
        esc = esc | new_esc
        settled = settled | new_esc
        p_hit = torch.where(refl[:, None], p_cr, p_hit)
        refl = refl & ~new_esc
        p_start = torch.where(refl[:, None], p_cr, p_start)
        p_end, u = _mirror(mesh, p_end, u, tet, p_cr, l_face, refl)
    new_pos = torch.where(hit[:, None], p_hit, pos)
    new_disp = torch.where(esc[:, None], torch.zeros_like(disp),
                           torch.where(hit[:, None], p_end - p_hit, disp))
    new_vel = torch.where(hit[:, None], u, vel)
    new_tet = torch.where(esc, tet_id, torch.where(hit, tet, tet_id))
    return new_pos, new_disp, new_vel, new_tet
