"""Seeding-time cell location (port of ``cudaparticlesfoam_tpu/ops/locate.py``).

* :func:`walk` — ``baryTetSearch`` (``query/RTQuery.cu:35-90``) as a masked
  torch loop over all lanes: step through the face of the most negative
  barycentric weight, at most ``max_hops`` hops, out-of-domain encoded as
  ``-(lastTet+1)``.  It runs once per seeding, not per cycle; the per-cycle
  walk lives in the rare-stage kernel (``ops/fused_cuda.py``).
* :class:`GridLocator` — a uniform grid of candidate start tets over the
  mesh bounds (the OptiX BVH broad phase's replacement), plus a host
  brute-force sweep for the few points the walk cannot reach.
* :func:`reflect_walls` — ``RTreflection`` across the outward face plane,
  the ConvexPoly rare stage's barycentric safety net
  (``StepConfig.convex_bary_fix``); its kernel form is in
  ``csrc/convex_rare.cu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import TetMesh
from .geometry import bary_from_tinv

MAX_HOPS = 50  # RTQuery.cu:42


def _bary_at(mesh: TetMesh, p, tet):
    """Barycentric weights [n, 4] of p in tet (clamped ids) via the walk
    table; same association order as ``geometry.bary_from_tinv``."""
    return bary_from_tinv(p, mesh.tet_a[tet], mesh.tet_tinv[tet])


def _argmin_first(w):
    """First-minimum argmin over the last axis (strict '<')."""
    best = w[:, 0]
    slot = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
    for i in range(1, w.shape[1]):
        upd = w[:, i] < best
        best = torch.where(upd, w[:, i], best)
        slot = torch.where(upd, torch.full_like(slot, i), slot)
    return slot, best


def walk(mesh: TetMesh, p, tet0, active=None, max_hops: int = MAX_HOPS, chain=None):
    """Vectorized ``baryTetSearch``.  Returns (tet, slot): the hosting tet,
    ``-(lastTet+1)`` on a domain exit, or the last visited tet when
    ``max_hops`` ran out; ``slot`` is the last face stepped through (-1 if
    none).  Negative ``tet0`` and inactive lanes pass through.  ``chain``
    (int64, one per lane): adds each lane's dependent loads, the tet's
    A/Tinv row per visit and the exit face's neighbour entry per step."""
    tet = tet0.to(torch.int64)
    done = tet < 0
    if active is not None:
        done = done | ~active
    slot = torch.full_like(tet, -1)
    for _ in range(max_hops):
        if bool(done.all()):
            break
        safe = tet.clamp(min=0)
        exit_slot, wmin = _argmin_first(_bary_at(mesh, p, safe))
        inside = wmin >= 0.0
        stepping = ~done & ~inside
        if chain is not None:
            chain += (~done).to(torch.int64) + stepping
        nbr = mesh.tet_nbr[safe, exit_slot].to(torch.int64)
        out = stepping & (nbr < 0)
        tet = torch.where(stepping, torch.where(nbr < 0, -(tet + 1), nbr), tet)
        slot = torch.where(stepping, exit_slot, slot)
        done = done | inside | out
    return tet.to(torch.int32), slot.to(torch.int32)


def reflect_walls(mesh: TetMesh, pos, disp, vel, tet_id, max_bounces: int = 10, chain=None):
    """Vectorized ``RTreflection`` (``RTQuery.cu:109-186``; JAX
    ``locate.reflect_walls``): for lanes with a wall-hit code (tet_id < 0)
    mirror the end point and velocity across the OUTWARD face plane
    (``tet_face_n``/``tet_face_d``) of the walk's exit face, re-walk,
    repeat up to ``max_bounces``; absorbing faces (``bd_escape``) settle
    the lane with tet = -(exitTet+1).  Returns (disp, vel, tet_id); lanes
    with tet_id >= 0 pass through.  ``chain``: adds the re-walks' loads
    (:func:`walk`) and one face plane per mirror."""
    tet_id = tet_id.to(torch.int64)
    hit = tet_id < 0
    tet_bd = torch.where(hit, -(tet_id + 1), tet_id)
    p_ref = pos + disp
    u_ref = vel
    settled = ~hit
    nbd = mesh.n_bd_faces
    for _ in range(max_bounces):
        if bool(settled.all()):
            break
        wtet, wslot = walk(mesh, p_ref, tet_bd, active=~settled, chain=chain)
        wtet, wslot = wtet.to(torch.int64), wslot.to(torch.int64)
        in_domain = wtet >= 0
        newly = ~settled & in_domain
        tet_bd = torch.where(newly, wtet, tet_bd)
        refl = ~settled & ~in_domain
        zero = torch.zeros_like(wtet)
        ex_tet = torch.where(refl, -(wtet + 1), zero)
        ex_slot = torch.where(refl, wslot.clamp(min=0), zero)
        code_nbr = mesh.tet_nbr[ex_tet, ex_slot].to(torch.int64)
        if nbd:
            bd = (-code_nbr - 1).clamp(0, nbd - 1)
            esc = refl & (code_nbr < 0) & mesh.bd_escape[bd]
        else:
            esc = torch.zeros_like(refl)
        tet_bd = torch.where(esc, -(ex_tet + 1), tet_bd)
        settled = settled | esc
        refl = refl & ~esc
        if chain is not None:
            chain += refl
        n = mesh.tet_face_n[ex_tet, ex_slot]
        d = mesh.tet_face_d[ex_tet, ex_slot]
        pn = (p_ref[:, 0] * n[:, 0] + p_ref[:, 1] * n[:, 1]) + p_ref[:, 2] * n[:, 2]
        un = (u_ref[:, 0] * n[:, 0] + u_ref[:, 1] * n[:, 1]) + u_ref[:, 2] * n[:, 2]
        p_new = p_ref - 2.0 * (pn - d)[:, None] * n
        u_new = u_ref - 2.0 * un[:, None] * n
        p_ref = torch.where(refl[:, None], p_new, p_ref)
        u_ref = torch.where(refl[:, None], u_new, u_ref)
        tet_bd = torch.where(refl, ex_tet, tet_bd)
        settled = settled | newly
    new_disp = torch.where(hit[:, None], p_ref - pos, disp)
    new_vel = torch.where(hit[:, None], u_ref, vel)
    new_tet = torch.where(hit, tet_bd, tet_id)
    return new_disp, new_vel, new_tet.to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class GridLocator:
    """Uniform grid of candidate starting tets over the mesh bounds."""

    cell_tet: torch.Tensor   # [gx*gy*gz] int32 candidate tet per cell
    origin: torch.Tensor     # [3]
    inv_cell: torch.Tensor   # [3]
    shape: tuple             # (gx, gy, gz)


def build_grid_locator(mesh: TetMesh, target_cells_per_tet: float = 1.0) -> GridLocator:
    """Host-side build: bin tet centroids; dilate to fill empty cells."""
    pts = mesh.host["points"].astype(np.float64)
    tets = mesh.host["tets"]
    cen = pts[tets].mean(axis=1)
    lo = mesh.host["bounds_lo"].astype(np.float64)
    hi = mesh.host["bounds_hi"].astype(np.float64)
    extent = np.maximum(hi - lo, 1e-300)
    n_tets = tets.shape[0]
    g = np.maximum(
        (extent / extent.prod() ** (1 / 3) * (n_tets * target_cells_per_tet) ** (1 / 3))
        .round()
        .astype(int),
        1,
    )
    gx, gy, gz = int(g[0]), int(g[1]), int(g[2])
    inv_cell = np.array([gx, gy, gz], dtype=np.float64) / extent

    idx = np.clip(((cen - lo) * inv_cell).astype(np.int64), 0, [gx - 1, gy - 1, gz - 1])
    flat = (idx[:, 0] * gy + idx[:, 1]) * gz + idx[:, 2]
    cell_tet = np.full(gx * gy * gz, -1, dtype=np.int32)
    cell_tet[flat] = np.arange(n_tets, dtype=np.int32)  # any tet per cell

    grid = cell_tet.reshape(gx, gy, gz)
    for _ in range(max(gx, gy, gz)):
        empty = grid < 0
        if not empty.any():
            break
        for axis in (0, 1, 2):
            for shift in (1, -1):
                src = np.roll(grid, shift, axis=axis)
                grid = np.where((grid < 0) & (src >= 0), src, grid)
    grid = np.where(grid < 0, 0, grid)

    dev, fdt = mesh.device, mesh.dtype
    return GridLocator(
        cell_tet=torch.as_tensor(grid.reshape(-1), device=dev),
        origin=torch.as_tensor(lo, dtype=fdt, device=dev),
        inv_cell=torch.as_tensor(inv_cell, dtype=fdt, device=dev),
        shape=(gx, gy, gz),
    )


def _grid_start_tet(loc: GridLocator, p):
    gx, gy, gz = loc.shape
    rel = (p - loc.origin) * loc.inv_cell
    hi = torch.tensor([gx - 1, gy - 1, gz - 1], dtype=torch.int32, device=p.device)
    # float -> int32 truncates toward zero, as jnp's astype does
    ij = torch.minimum(torch.maximum(rel.to(torch.int32), torch.zeros_like(hi)), hi)
    flat = (ij[:, 0] * gy + ij[:, 1]) * gz + ij[:, 2]
    return loc.cell_tet[flat.long()]


def brute_force_resolve(mesh: TetMesh, p, tet) -> np.ndarray:
    """Host-side exact fallback for lanes the walk could not place
    (tet < 0): test every tet, chunked over particles.  Seeds outside the
    domain stay -1 (killed at the first advect, ``particles.cu:262-266``)."""
    tet = (tet.cpu().numpy() if torch.is_tensor(tet) else np.asarray(tet)).copy()
    bad = np.nonzero(tet < 0)[0]
    if len(bad) == 0:
        return tet
    pn = p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p)
    p_bad = pn[bad].astype(np.float64)
    a = mesh.host["tet_a"].astype(np.float64)
    tinv = mesh.host["tet_tinv"].astype(np.float64)
    # chunk of 32 points keeps the [b, nt, 3] temporary under 1 GB at 1M tets
    for i0 in range(0, len(bad), 32):
        sel = bad[i0 : i0 + 32]
        rel = p_bad[i0 : i0 + 32][:, None, :] - a[None, :, :]
        wbcd = np.einsum("tij,btj->bti", tinv, rel)
        inside = (wbcd.min(axis=-1) >= 0.0) & (wbcd.sum(axis=-1) <= 1.0)
        hit = inside.any(axis=1)
        first = inside.argmax(axis=1)
        tet[sel] = np.where(hit, first, -1).astype(np.int32)
    return tet


def first_locate(mesh: TetMesh, loc: GridLocator, p) -> torch.Tensor:
    """Grid candidate tet, then the bary walk (``RTQuery.cu:295-310``)."""
    tet, _ = walk(mesh, p, _grid_start_tet(loc, p))
    return tet


def locate_seeds(mesh: TetMesh, loc: GridLocator, p) -> torch.Tensor:
    """:func:`first_locate` + the host brute-force fallback."""
    tet = first_locate(mesh, loc, p)
    if bool((tet < 0).any()):
        tet = torch.as_tensor(brute_force_resolve(mesh, p, tet),
                              dtype=torch.int32, device=p.device)
    return tet
