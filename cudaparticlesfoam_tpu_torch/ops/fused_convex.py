"""Row-cached fused sub-step for the ConvexPoly locate mode (port of
``cudaparticlesfoam_tpu/ops/fused_convex.py``).

The mega state is row-major ``[n, 32]``: 0:3 pos (the segment START while
a lane is pending; the final pos after the cycle) | 3:6 vel | 6 tet
(exact float integer) | 7 active | 8:32 the lane's cached ``cx_table`` row
(outward plane normals 8:20, offsets 20:24, neighbour codes 24:28, tet
velocity 28:31, 0).  The mega has no room for the displacement, so the
stream hands it to the rare stage in a side array ``disp`` [n, 3].

One cycle is two kernels (``ops/fused_cuda.py``):

1. **convex stream** (K5, ``csrc/convex_stream.cu``): advect, Brownian
   kick, the segment ``seg = (p0 + d) - p0``, the ``traceIntet`` exit test
   on the cached row (``face_dist < tol``, ``tol < dT <= 1``), the leak
   guard, and with ``inline_hops >= 1`` one inline hop: a lane whose
   segment crosses one interior face and ends in that neighbour takes the
   neighbour's row.  Other crossers become pending and keep their start.
2. **convex rare** (``csrc/convex_rare.cu``): each pending lane runs
   ``trace_segment`` (``cfg.max_hops`` tets), ``convex_reflect`` (5
   bounces, 50-tet re-traces) and, with ``convex_bary_fix``, the
   barycentric walk + ``reflect_walls`` safety net, then refreshes its row.

:func:`convex_stream_plain` and :func:`convex_rare_plain` are the plain
PyTorch versions of the two kernels: ``_cycle_aligned`` (stream section,
``fused_convex.py:110-219``) and ``_make_run_lanes`` (``:222-267``) over
the pending lanes without compaction.
"""

from __future__ import annotations

import torch

from ..mesh import CX_ROW_W, TetMesh
from . import convex as convex_ops
from . import locate as locate_ops
from .fused import (ACT, HOP_GROUP, P0, ROW, TET, V0, compact_scratch, stream_kwargs,
                    cycle_noise, hop_capacity)

WIDTH = 32
ROW_W = CX_ROW_W            # 8 + 24 = WIDTH: no pad column
RU = ROW + 20               # tet velocity at 28:31

# came-from sentinel that never equals a neighbour code
_NO_INLET = -(2 ** 30)


def cx_table(mesh: TetMesh) -> torch.Tensor:
    """[nt, 24] engine table (``mesh.tet_row_cxe``, attached by
    ``mesh.with_convex_rows``)."""
    if mesh.tet_row_cxe is None:
        raise ValueError("the convex engine needs mesh.with_convex_rows(mesh)")
    return mesh.tet_row_cxe


def _row_tables(rows):
    """(normals [c,4,3], offsets [c,4], nbr [c,4] int64) of [c, 24] rows."""
    return rows[:, 0:12].reshape(-1, 4, 3), rows[:, 12:16], rows[:, 16:20].to(torch.int64)


# ---------------------------------------------------------------------------
# K5: the convex stream (plain version of csrc/convex_stream.cu)
# ---------------------------------------------------------------------------


def convex_stream_plain(tab, m, xi, pending, disp, *, dt, sigma, use_adv, use_brown,
                        n_hops, admit=None, crossers=None):
    """Plain version of ``convex_stream_kernel``: updates ``m`` [n, 32] in
    place, writes ``pending`` [n] uint8 and ``disp`` [n, 3] (the cycle's
    displacement, read by the rare stage for pending lanes).  ``dt`` and
    ``sigma`` are rounded to m's dtype (``fused.scalars``); ``xi`` [n, 3]
    is read iff ``use_brown``.

    The two stages of the compacted hop gather (``_kernel_cb_packed_c``):
    with ``crossers`` [n] uint8 the call only writes each lane's
    interior-crossing flag (m, pending and disp are left alone); with
    ``admit`` [n] uint8 an interior crosser whose flag is 0 does not hop
    and stays pending with its start point, pre-hop tet and row."""
    T, dev = m.dtype, m.device
    dt = torch.tensor(dt, dtype=T, device=dev)
    sigma = torch.tensor(sigma, dtype=T, device=dev)

    tet = m[:, TET].to(torch.int64)
    act = m[:, ACT] > 0.5
    alive = (act & (tet >= 0)) if use_adv else act
    alf = alive.to(T)
    ux, uy, uz = m[:, RU], m[:, RU + 1], m[:, RU + 2]
    if use_adv:
        dx, dy, dz = alf * ux * dt, alf * uy * dt, alf * uz * dt
        vx = torch.where(alive, ux, m[:, V0])
        vy = torch.where(alive, uy, m[:, V0 + 1])
        vz = torch.where(alive, uz, m[:, V0 + 2])
    else:
        dx = dy = dz = torch.zeros_like(ux)
        vx, vy, vz = m[:, V0], m[:, V0 + 1], m[:, V0 + 2]
    if use_brown:
        dx = dx + alf * sigma * xi[:, 0]
        dy = dy + alf * sigma * xi[:, 1]
        dz = dz + alf * sigma * xi[:, 2]
    actf = alf if use_adv else m[:, ACT]

    ex = m[:, P0] + dx
    ey = m[:, P0 + 1] + dy
    ez = m[:, P0 + 2] + dz
    p0 = m[:, P0 : P0 + 3]
    p_end = torch.stack([ex, ey, ez], dim=1)
    seg = p_end - p0           # not d itself: the ulps differ
    rows0 = m[:, ROW : ROW + ROW_W]
    nrm0, dpl0, nbr0 = _row_tables(rows0)
    dt0, slot0 = convex_ops._exit_face_tables(nrm0, dpl0, p0, seg, nbr0 == _NO_INLET)
    # leak guard: a start point outside its cached tet (tolerance dust)
    fd0 = (nrm0[:, :, 0] * p0[:, None, 0] + nrm0[:, :, 1] * p0[:, None, 1]
           + nrm0[:, :, 2] * p0[:, None, 2] - dpl0)
    tol = torch.tensor(convex_ops.TOL, dtype=T, device=dev)
    outside0 = alive & (fd0.max(dim=1).values > tol)
    crossing = alive & ((slot0 >= 0) | outside0)
    nxt0 = torch.where(slot0 >= 0, convex_ops._pick(nbr0, slot0.clamp(min=0)),
                       torch.zeros_like(slot0))
    interior = crossing & (nxt0 >= 0) & (slot0 >= 0)
    if crossers is not None:
        crossers.copy_(interior)
        return

    tet_new, row_new = tet, rows0
    res2 = torch.zeros_like(crossing)
    if n_hops >= 1:
        # one inline hop: the segment crosses one interior face and ends
        # in that neighbour (inlet face suppressed by its came-from code)
        if admit is not None:
            interior = interior & (admit > 0)
        rows_g = tab[torch.where(interior, nxt0, tet.clamp(min=0))]
        p1 = p0 + dt0[:, None] * seg
        nrm1, dpl1, nbr1 = _row_tables(rows_g)
        _, slot1 = convex_ops._exit_face_tables(nrm1, dpl1, p1, p_end - p1,
                                                nbr1 == tet[:, None])
        res2 = interior & (slot1 < 0)
        tet_new = torch.where(res2, nxt0, tet)
        # vel keeps the OLD tet's advected velocity (particles.cu:361)
        row_new = torch.where(res2[:, None], rows_g, rows0)
    pend = crossing & ~res2
    fin = ~pend
    head = torch.stack([
        torch.where(fin, ex, m[:, P0]), torch.where(fin, ey, m[:, P0 + 1]),
        torch.where(fin, ez, m[:, P0 + 2]), vx, vy, vz, tet_new.to(T), actf], dim=1)
    disp.copy_(torch.stack([dx, dy, dz], dim=1))
    m.copy_(torch.cat([head, row_new], dim=1))
    pending.copy_(pend)


# ---------------------------------------------------------------------------
# the convex rare stage (plain version of csrc/convex_rare.cu)
# ---------------------------------------------------------------------------


def _rare_lanes(mesh, tab, m, disp, idx, max_hops, reflect_wall, bary_fix, max_bounces,
                chain):
    """The new convex mega rows of lanes ``idx``."""
    mc = m[idx]
    dsub = disp[idx]
    pos = mc[:, P0 : P0 + 3]
    vel = mc[:, V0 : V0 + 3]
    code, stop_tet, p_cross, hit_face = convex_ops.trace_segment(
        mesh, pos, dsub, mc[:, TET].to(torch.int64), max_tets=max_hops, chain=chain)
    d2 = dsub
    if reflect_wall:
        pos, d2, vel, code = convex_ops.convex_reflect(
            mesh, pos, d2, vel, code, stop_tet, p_cross, hit_face, chain=chain)
        if bary_fix:
            p_land = pos + d2
            tet_chk, _ = locate_ops.walk(mesh, p_land, code, chain=chain)
            d_fix, vel, code = locate_ops.reflect_walls(
                mesh, p_land, torch.zeros_like(d2), vel, tet_chk, max_bounces=max_bounces,
                chain=chain)
            d2 = d2 + d_fix
    if chain is not None:
        chain += 1        # the refreshed cx_table row
    code = code.to(torch.int64)
    return torch.cat([pos + d2, vel, code.to(m.dtype)[:, None], mc[:, ACT : ACT + 1],
                      tab[code.clamp(min=0)]], dim=1)


def convex_rare_plain(mesh: TetMesh, tab, m, disp, pending, *, max_hops,
                      reflect_wall, bary_fix, max_bounces, chain=None):
    """Plain version of ``convex_rare_kernel``: every lane whose ``pending``
    flag is set marches from its start (pos columns) by ``disp``: trace,
    convex reflection, barycentric safety net; pos/vel/tet and the row
    cache are updated in place, the active column is left as is.
    ``chain`` ([n_pending] int64 zeros): receives each pending lane's chain
    (:func:`rare_chain`)."""
    idx = pending.nonzero()[:, 0]
    if idx.numel() == 0:
        return
    m[idx] = _rare_lanes(mesh, tab, m, disp, idx, max_hops, reflect_wall, bary_fix,
                         max_bounces, chain)


def rare_chain(mesh: TetMesh, tab, m, disp, pending, *, max_hops, reflect_wall, bary_fix,
               max_bounces):
    """The dependent chain of each pending lane of ``convex_rare_kernel``,
    in lane order: [n_pending] int64 row loads beyond the flag and the
    lane's own mega row: one cx row per tet the trace and each re-trace
    after a bounce visit, with ``convex_bary_fix`` one A/Tinv row per tet
    the walks visit, one neighbour entry per step and one face plane per
    mirror, and the refreshed cx_table row.  The face matching and the
    convex mirror re-read the row the trace ended in and add nothing.
    ``m`` is not touched; the arguments are :func:`convex_rare_plain`'s."""
    idx = pending.nonzero()[:, 0]
    chain = torch.zeros(idx.shape[0], dtype=torch.int64, device=m.device)
    if idx.numel():
        _rare_lanes(mesh, tab, m, disp, idx, max_hops, reflect_wall, bary_fix, max_bounces,
                    chain)
    return chain


# ---------------------------------------------------------------------------
# one cycle
# ---------------------------------------------------------------------------


def mega_cycle(mesh: TetMesh, tab, m, seed, step, cfg, dt, noise=None, pending=None,
               disp=None, scratch=None, lane_offset=0) -> torch.Tensor:
    """One convex sub-step over the mega state, in place: the convex stream
    kernel, then the convex rare kernel over the pending lanes.  ``noise``
    [n, 3] replaces the noise draw (replays); under ``brownian_rng``
    "rbg"/"rbg_kernel" a CUDA mega draws the Philox stream inside the
    stream kernel.  ``pending`` [n] uint8, ``disp`` [n, 3] and ``scratch``
    (``fused.compact_scratch``, used under ``hop_compact=4``) are optional
    buffers.

    With ``hop_compact=4`` and ``inline_hops >= 1`` the stream runs as the
    compacted hop gather (crossing flags, ``hop_admit``, then the stream
    kernel with the admission flags), whatever the lane count: the JAX
    package engages it on its TPU packed path only.  The state after the
    rare stage is the same either way.  ``lane_offset``: as in
    ``fused.mega_cycle``."""
    from . import fused_cuda

    n, dev = m.shape[0], m.device
    if pending is None:
        pending = torch.empty(n, dtype=torch.uint8, device=dev)
    if disp is None:
        disp = torch.empty((n, 3), dtype=m.dtype, device=dev)
    xi, key = cycle_noise(cfg, seed, step, n, m.dtype, dev, noise, lane_offset=lane_offset)
    kw = stream_kwargs(cfg, dt, m.dtype)
    admit = None
    if cfg.hop_compact == HOP_GROUP and cfg.inline_hops >= 1:
        sc = compact_scratch(n, dev) if scratch is None else scratch
        crossers, admit = sc["crossers"], sc["admit"]
        fused_cuda.convex_stream_crossers(tab, m, xi, crossers, noise_key=key, **kw)
        fused_cuda.hop_admit(crossers, admit, capb=hop_capacity(n, cfg.hop_compact_frac),
                             scratch=sc["words"])
    fused_cuda.convex_stream_cycle(tab, m, xi, pending, disp, n_hops=cfg.inline_hops,
                                   noise_key=key, admit=admit, **kw)
    fused_cuda.convex_rare_resolve(
        mesh, tab, m, disp, pending, max_hops=cfg.max_hops,
        reflect_wall=cfg.reflect_wall, bary_fix=cfg.convex_bary_fix,
        max_bounces=cfg.max_bounces)
    return m
