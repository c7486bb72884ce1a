"""Slab-partitioned meshes with cross-shard particle migration (port of
``cudaparticlesfoam_tpu/parallel/partition.py``).

When the tet mesh is too large to replicate, each shard holds one slab of
the walk table, particles ride the shard whose slab holds their tet, and
a particle that crosses into another slab migrates.

* **Partition** (host, numpy): tets sorted by centroid along the longest
  axis of the bounding box into S equal slabs, renumbered so that
  ``shard_of(tet) = tet // per``.  A shard's rows carry their neighbour
  codes locally encoded (:func:`_encode_local_nbr`): in-slab tets as local
  ids, boundary codes as they are, a tet g of another slab as
  ``-(R0 + 1 + g)``, R0 the boundary face count.
* **Cycle** (per shard): migrated arrivals settle (the hop-0 test, then the
  rare stage with no displacement), then the cached engine's cycle runs
  with ``inline_bounce=False`` and ``escape_faces=False`` (walls and
  escapes go to the rare stage, bit for bit the same per bounce): on the
  card ``rare_kernel<T, L, kRemote>``, ``stream_kernel`` and
  ``rare_kernel<T, L, kRemote>`` again.  A walk that meets a remote code
  pauses with the sentinel tet ``-(per + g + 1)``.  Under ConvexPoly the
  shard runs :func:`_local_cycle_cx` (torch ops, as JAX's is jnp).
* **Migration**: a fixed-capacity exchange (:func:`all_to_all`) with
  two-phase admission (each receiver grants its free slots over the
  requesting senders in source order), so no lane is dropped; a lane over
  its grant stays resident in limbo and retries next cycle.

Brownian noise is keyed by (seed, step, global particle id): row pid of
``fused.philox_normals(fused.philox_key(seed, step), ...)``, the "rbg"
stream, so a particle's noise is the same on any shard count and after any
migration, and equals a single-device run's under ``brownian_rng="rbg"``.
JAX keys it by threefry ``fold_in(key, step, pid)``, which torch cannot
reproduce; both ignore ``brownian_rng`` on this path.

Limits: ``per + n_tets < 2**24`` and ``R0 + 1 + n_tets < 2**24`` in
float32 (the sentinels and codes are exact float integers);
:func:`partition_mesh` checks both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import PK_ROW_W, TetMesh
from ..ops import fused, fused_cuda
from ..ops import convex as convex_ops
from ..stepper import StepConfig
from .sharding import on_device

P0, V0, TET, ACT, ROW = fused.P0, fused.V0, fused.TET, fused.ACT, fused.ROW
NBR_COL = {"pk": 24, "cx": 16, "tet": 15}
F32_EXACT = 1 << 24


@dataclasses.dataclass(eq=False)
class PartitionedMesh:
    """Slab-partitioned walk tables, one tensor per shard."""

    tet_row: list        # S x [per, 20 | 32 | 24], neighbour codes locally encoded
    tet_nbr: list        # S x [per, 4] int32 global codes (new numbering)
    perm: torch.Tensor   # [nt] int64 old tet id -> new
    inv_perm: torch.Tensor   # [nt] int64 new -> old
    bd_escape: list      # S x [n_bd] bool (replicated; absorbing faces)
    n_shards: int
    tets_per_shard: int
    n_tets: int
    layout: str          # "tet", "pk" (the padded 32-column rows) or "cx"


@dataclasses.dataclass(eq=False)
class ShardedParticles:
    """Per-shard particle slots with a residency mask."""

    pos: list            # S x [C, 3]
    vel: list            # S x [C, 3]
    disp: list           # S x [C, 3]: pending displacement (convex hand-offs)
    tet: list            # S x [C] int32, global new-numbering ids
    active: list         # S x [C] bool (particle alive)
    resident: list       # S x [C] bool (slot occupied)
    pid: list            # S x [C] int32 global particle id (-1 = empty)
    seed: int
    step: int
    n_shards: int
    capacity: int


def all_to_all(send, devices):
    """JAX's ``lax.all_to_all(x, "s", split_axis=0, concat_axis=0)`` over
    a list of per-shard tensors ``send[s]`` [S, ...]: ``recv[d][s] =
    send[s][d]``, on ``devices[d]``."""
    S = len(send)
    return [torch.stack([send[s][d].to(devices[d]) for s in range(S)]) for d in range(S)]


def _encode_local_nbr(nbr, per, R0, xp):
    """Local encoding of GLOBAL neighbour codes ([S*per, 4], shard s owns
    rows [s*per, (s+1)*per)): in-shard tets -> local ids, boundary codes
    (< 0) unchanged, remote tets -> ``-(R0+1+g)``.  ``xp``: numpy, or torch
    for the device-side geometry refresh; both exact integers."""
    n = nbr.shape[0]
    if xp is np:
        lo = (np.arange(n, dtype=nbr.dtype) // per * per)[:, None]
        in_sh = (nbr >= lo) & (nbr < lo + per)
        return np.where(in_sh, nbr - lo, np.where(nbr < 0, nbr, -(R0 + 1 + nbr)))
    lo = (torch.arange(n, dtype=nbr.dtype, device=nbr.device) // per * per)[:, None]
    in_sh = (nbr >= lo) & (nbr < lo + per)
    return torch.where(in_sh, nbr - lo, torch.where(nbr < 0, nbr, -(R0 + 1 + nbr)))


def _check_exact(per, nt, R0, dtype):
    if dtype == np.float32 and (per + nt >= F32_EXACT or R0 + 1 + nt >= F32_EXACT):
        raise ValueError(
            f"float32 partitioned tables need per + n_tets < 2**24 and R0 + 1 + n_tets < "
            f"2**24 (exact sentinels and codes): per={per}, n_tets={nt}, R0={R0}")


def _source_rows(mesh: TetMesh, layout: str, host: bool):
    """The [nt, w] rows a layout slices: ``tet_row``, the padded Pk rows
    (``tet_row_pk32``) or the convex engine's ``tet_row_cxe``."""
    if layout == "pk":
        if mesh.tet_row_pk is None:
            raise ValueError("pk layout needs mesh.tet_row_pk (with_pk_rows)")
        if host:
            src = mesh.host["tet_row_pk"]
            out = np.zeros((src.shape[0], fused.LAYOUT_PK.tab_w), src.dtype)
            out[:, :PK_ROW_W] = src
            return out
        return mesh.tet_row_pk32
    if layout == "cx":
        if mesh.tet_row_cx is None:
            raise ValueError("cx layout needs mesh.tet_row_cx (with_convex_rows)")
        return mesh.host["tet_row_cxe"] if host else mesh.tet_row_cxe
    if layout != "tet":
        raise ValueError(f"unknown partition layout {layout!r}")
    return mesh.host["tet_row"] if host else mesh.tet_row


def partition_mesh(mesh: TetMesh, n_shards: int, layout: str = "tet") -> PartitionedMesh:
    """Slab-partition ``mesh`` along the longest bounding-box axis, every
    shard's tables on the mesh's device (:func:`shard_arrays` places them).

    ``layout``: "tet" slices the 20-column TetVelocity rows, "pk" the
    VertexVelocity rows as the port's kernels read them (``tet_row_pk32``,
    32 columns, codes at 24:28), "cx" the 24-column ConvexPoly rows
    (inward planes 0:16, codes 16:20, tet velocity 20:23)."""
    h = mesh.host
    pts = h["points"].astype(np.float64)
    tets = h["tets"]
    cen = pts[tets].mean(axis=1)
    extent = h["bounds_hi"].astype(np.float64) - h["bounds_lo"].astype(np.float64)
    axis = int(np.argmax(extent))
    order = np.argsort(cen[:, axis], kind="stable")     # old ids in new order
    nt = len(order)
    per = -(-nt // n_shards)
    pad = per * n_shards - nt
    inv_perm = order.astype(np.int64)
    perm = np.empty(nt, np.int64)
    perm[order] = np.arange(nt, dtype=np.int64)

    src = _source_rows(mesh, layout, host=True)
    w = src.shape[1]
    row = src[inv_perm].copy()
    nbr_old = h["tet_nbr"][inv_perm]
    nbr = np.where(nbr_old >= 0, perm[np.clip(nbr_old, 0, nt - 1)], nbr_old).astype(np.int64)
    if pad:
        # padding tets: self-contained dummies (all boundary), never reached
        prow = np.zeros((pad, w), row.dtype)
        prow[:, 3] = prow[:, 7] = prow[:, 11] = 1.0     # identity Tinv
        row = np.concatenate([row, prow])
        nbr = np.concatenate([nbr, np.full((pad, 4), -1, np.int64)])
    bd_esc = h["bd_escape"]
    if bd_esc.size == 0:
        bd_esc = np.zeros(1, bool)
    R0 = bd_esc.shape[0]
    _check_exact(per, nt, R0, row.dtype)
    c = NBR_COL[layout]
    row[:, c : c + 4] = _encode_local_nbr(nbr, per, R0, np).astype(row.dtype)
    dev = mesh.device
    rows = torch.from_numpy(row.reshape(n_shards, per, w)).to(dev)
    nbrs = torch.from_numpy(nbr.astype(np.int32).reshape(n_shards, per, 4)).to(dev)
    esc = torch.from_numpy(bd_esc).to(dev)
    return PartitionedMesh(
        tet_row=list(rows.unbind(0)), tet_nbr=list(nbrs.unbind(0)),
        perm=torch.from_numpy(perm).to(dev), inv_perm=torch.from_numpy(inv_perm).to(dev),
        bd_escape=[esc] * n_shards, n_shards=n_shards, tets_per_shard=per, n_tets=nt,
        layout=layout)


def _split_rows(pm: PartitionedMesh, tv, u0):
    """``pm`` with each shard's rows taking the new-numbering, padded
    velocity block ``tv`` [S*per, uw] at columns u0.."""
    S, per = pm.n_shards, pm.tets_per_shard
    pad = S * per - pm.n_tets
    if pad:
        tv = torch.cat([tv, torch.zeros((pad, tv.shape[1]), dtype=tv.dtype, device=tv.device)])
    rows = []
    for s, r in enumerate(pm.tet_row):
        r = r.clone()
        r[:, u0 : u0 + tv.shape[1]] = tv[s * per : (s + 1) * per].to(r.device)
        rows.append(r)
    return dataclasses.replace(pm, tet_row=rows)


def update_velocity(pm: PartitionedMesh, tet_vel, vert_vel=None, tets=None) -> PartitionedMesh:
    """Refresh the velocity columns of the partitioned rows from GLOBAL
    (old-numbering) velocities without re-partitioning (the coupled and
    replay drivers' U refresh, ``advect.H:44-83``): "tet" (cols 12:15) and
    "cx" (20:23) rows take ``tet_vel``; "pk" rows take ``vert_vel`` and
    the connectivity ``tets`` (v0..v3 at 12:24)."""
    T = pm.tet_row[0].dtype
    dev = pm.inv_perm.device
    if pm.layout == "pk":
        if vert_vel is None or tets is None:
            raise ValueError("pk-row velocity refresh needs vert_vel and tets")
        vv = torch.as_tensor(vert_vel, dtype=T, device=dev)
        tv = vv[torch.as_tensor(tets, device=dev).long()].reshape(-1, 12)[pm.inv_perm]
        return _split_rows(pm, tv, 12)
    tv = torch.as_tensor(tet_vel, dtype=T, device=dev)[pm.inv_perm]
    return _split_rows(pm, tv, 12 if pm.layout == "tet" else 20)


def refresh_geometry(pm: PartitionedMesh, mesh: TetMesh, layout: str | None = None
                     ) -> PartitionedMesh:
    """Rebuild the per-shard tables from a MOVED mesh (same tets and
    adjacency) without re-partitioning: the slab assignment, shapes and
    particle tet ids survive; only the rows change, gathered on the device
    from the mesh's refreshed tables, their codes re-encoded from the
    partition's ``tet_nbr``."""
    layout = pm.layout if layout is None else layout
    if layout != pm.layout:
        raise ValueError(f"geometry refresh changed the layout ({pm.layout} -> {layout}); "
                         f"the partition layout must stay fixed")
    S, per = pm.n_shards, pm.tets_per_shard
    dev = pm.inv_perm.device
    src = _source_rows(mesh, layout, host=False).to(dev)
    row = src[pm.inv_perm]
    pad = S * per - pm.n_tets
    if pad:
        prow = torch.zeros((pad, row.shape[1]), dtype=row.dtype, device=dev)
        prow[:, 3] = prow[:, 7] = prow[:, 11] = 1.0
        row = torch.cat([row, prow])
    bd_esc = mesh.bd_escape.to(dev)
    if bd_esc.numel() == 0:
        bd_esc = torch.zeros(1, dtype=torch.bool, device=dev)
    c = NBR_COL[layout]
    nbr = torch.cat([t.to(dev) for t in pm.tet_nbr]).to(torch.int64)
    row[:, c : c + 4] = _encode_local_nbr(nbr, per, bd_esc.shape[0], torch).to(row.dtype)
    rows = [row[s * per : (s + 1) * per].to(pm.tet_row[s].device) for s in range(S)]
    return dataclasses.replace(pm, tet_row=rows,
                               bd_escape=[bd_esc.to(e.device) for e in pm.bd_escape])


def distribute_particles(pm: PartitionedMesh, pos, vel, tet_old, active, seed: int = 0,
                         slack: float = 2.0, capacity: int | None = None,
                         step: int = 0) -> ShardedParticles:
    """Host side: route particles to the shard owning their tet (stable
    ascending pid within a shard); ``capacity`` pins the slot count of a
    re-distribution into an existing engine; ``step`` carries the cycle
    counter (the noise is keyed by (step, pid)).  The slots land on the
    mesh's device (:func:`shard_arrays` places them)."""
    S, per = pm.n_shards, pm.tets_per_shard

    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    dtype = pos.dtype if torch.is_tensor(pos) else torch.from_numpy(np.asarray(pos)).dtype
    pos, vel, tet_old, active = host(pos), host(vel), host(tet_old), host(active)
    n = len(pos)
    perm = pm.perm.cpu().numpy()
    tet_new = np.where(tet_old >= 0, perm[np.clip(tet_old, 0, pm.n_tets - 1)], tet_old)
    dest = np.clip(np.where(tet_new >= 0, tet_new // per, 0), 0, S - 1)
    # capacity covers the worst-loaded shard at seeding plus migration slack
    max_load = int(np.bincount(dest, minlength=S).max()) if n else 0
    cap = max(int(n / S * slack), int(max_load * 1.25) + 1, 64)
    cap = -(-cap // 8) * 8
    if capacity is not None:
        if max_load > capacity:
            raise ValueError(
                f"shard capacity {capacity} exceeded at re-distribution (worst shard holds "
                f"{max_load}); rebuild the engine with a larger slack")
        cap = capacity
    ppos = np.zeros((S, cap, 3))
    pvel = np.zeros((S, cap, 3))
    ptet = np.full((S, cap), -1, np.int32)
    pact = np.zeros((S, cap), bool)
    pres = np.zeros((S, cap), bool)
    ppid = np.full((S, cap), -1, np.int32)
    if n:
        if max_load > cap:
            raise ValueError("shard capacity exceeded at distribution")
        order = np.argsort(dest, kind="stable")
        ds = dest[order]
        starts = np.searchsorted(ds, np.arange(S))
        k = np.arange(n, dtype=np.int64) - starts[ds]
        ppos[ds, k] = pos[order]
        pvel[ds, k] = vel[order]
        ptet[ds, k] = tet_new[order]
        pact[ds, k] = active[order]
        pres[ds, k] = True
        ppid[ds, k] = order
    dev = pm.perm.device

    def put(a, dt=None):
        t = torch.from_numpy(a).to(dev)
        return list((t if dt is None else t.to(dt)).unbind(0))

    return ShardedParticles(
        pos=put(ppos, dtype), vel=put(pvel, dtype), disp=put(np.zeros((S, cap, 3)), dtype),
        tet=put(ptet), active=put(pact), resident=put(pres), pid=put(ppid),
        seed=int(seed), step=int(step), n_shards=S, capacity=cap)


def collect_particles(pm: PartitionedMesh, sp: ShardedParticles, n_particles: int):
    """Host side: the shards gathered back into globally ordered numpy
    arrays (pos, vel, tet in the original numbering, active)."""
    pos = np.zeros((n_particles, 3))
    vel = np.zeros((n_particles, 3))
    tet = np.full(n_particles, -1, np.int32)
    act = np.zeros(n_particles, bool)
    inv = pm.inv_perm.cpu().numpy()
    for s in range(sp.n_shards):
        sel = sp.resident[s].cpu().numpy()
        ids = sp.pid[s].cpu().numpy()[sel]
        pos[ids] = sp.pos[s].cpu().numpy()[sel]
        vel[ids] = sp.vel[s].cpu().numpy()[sel]
        t = sp.tet[s].cpu().numpy()[sel]
        # hosting tets and -(tet+1) exit codes both map back to the old numbering
        neg = t < 0
        t_new = np.where(neg, -t - 1, t)
        t_old = inv[np.clip(t_new, 0, pm.n_tets - 1)]
        tet[ids] = np.where(neg, -(t_old + 1), t_old)
        act[ids] = sp.active[s].cpu().numpy()[sel]
    return pos, vel, tet, act


def shard_arrays(pm: PartitionedMesh, sp: ShardedParticles, devices):
    """Place shard s's tables and slots on ``devices[s]``; the
    permutations stay on the first device."""
    if len(devices) != pm.n_shards:
        raise ValueError(f"{len(devices)} devices for {pm.n_shards} shards")

    def place(xs):
        return [x.to(d) for x, d in zip(xs, devices)]

    pm = dataclasses.replace(
        pm, tet_row=place(pm.tet_row), tet_nbr=place(pm.tet_nbr),
        perm=pm.perm.to(devices[0]), inv_perm=pm.inv_perm.to(devices[0]),
        bd_escape=place(pm.bd_escape))
    sp = dataclasses.replace(
        sp, pos=place(sp.pos), vel=place(sp.vel), disp=place(sp.disp), tet=place(sp.tet),
        active=place(sp.active), resident=place(sp.resident), pid=place(sp.pid))
    return pm, sp


# ---------------------------------------------------------------------------
# the per-shard cycle
# ---------------------------------------------------------------------------


class _CachedCtx:
    """One shard's cached-engine context: its slab of rows (codes locally
    encoded), layout, configuration, and the arguments of its
    remote-pausing rare stage.  The shard cycle is JAX's with
    ``inline_bounce=False``, ``escape_faces=False``, the Euler integrator
    and the barycentric walk whatever ``cfg`` says (``partition.py:473-477``):
    :func:`_cycle` passes those to the kernels."""

    def __init__(self, rows, bd_esc, per, cfg):
        self.tab, self.bd_esc, self.per, self.cfg = rows, bd_esc, per, cfg
        self.R0 = bd_esc.shape[0]
        self.ly = fused.LAYOUT_PK if rows.shape[1] == fused.LAYOUT_PK.tab_w else fused.LAYOUT_TET
        self.rare = dict(max_hops=cfg.max_hops, max_bounces=cfg.max_bounces,
                         reflect_wall=cfg.reflect_wall, ly=self.ly, remote=(self.R0, per))

    def pack(self, pos, vel, tl, live):
        """The mega of slots with local tets ``tl`` (one row gather)."""
        m = torch.zeros((pos.shape[0], self.ly.width), dtype=pos.dtype, device=pos.device)
        m[:, P0 : P0 + 3] = pos
        m[:, V0 : V0 + 3] = vel
        m[:, TET] = tl.to(pos.dtype)
        m[:, ACT] = live.to(pos.dtype)
        m[:, ROW : ROW + self.ly.tab_w] = self.tab[tl.long().clamp(0, self.per - 1)]
        return m


def _pid_noise(seed, step, pid, cfg, dtype):
    """Brownian noise keyed by (seed, step, global particle id): row pid of
    the "rbg" Philox stream of (seed, step), stable across migrations and
    shard counts (an empty slot takes pid 0's row, as JAX's does)."""
    if not cfg.use_brownian:
        return None
    lanes = pid.long().clamp(min=0)
    return fused.philox_normals(fused.philox_key(seed, step), lanes.shape[0], dtype,
                                pid.device, lanes=lanes)


def settle_flags(m):
    """The settle call's pending lanes: active lanes outside their cached
    tet (the hop-0 test on the mega's row cache)."""
    w4 = fused._bary(m[:, ROW : ROW + 12], m[:, 0], m[:, 1], m[:, 2])
    wmin = torch.minimum(torch.minimum(w4[0], w4[1]), torch.minimum(w4[2], w4[3]))
    return (m[:, ACT] > 0.5) & (wmin < 0.0)


def _settle(ctx: _CachedCtx, m, pending):
    """Settle migrated arrivals, in place on ``m``: :func:`settle_flags`,
    then the remote rare stage with no displacement (the bespoke
    ``relocate(pos, tet, live)``), so that an arrival sits in its tet before
    the advect."""
    pending.copy_(settle_flags(m))
    fused_cuda.rare_resolve(ctx.tab, m, pending, ctx.bd_esc, **ctx.rare)


def _cycle(ctx: _CachedCtx, m, noise, dt, pending):
    """The cached engine's cycle with the remote-pausing rare stage, in
    place on ``m``: ``stream_kernel`` (no inline bounce, no escape faces),
    then ``rare_kernel<T, L, kRemote>`` on its pending lanes."""
    cfg = ctx.cfg
    fused_cuda.stream_cycle(
        ctx.tab, m, noise if cfg.use_brownian else None, pending, bounce_on=False,
        esc_on=False, n_hops=cfg.inline_hops, ly=ctx.ly, **fused.stream_kwargs(cfg, dt, m.dtype))
    fused_cuda.rare_resolve(ctx.tab, m, pending, ctx.bd_esc, **ctx.rare)


def _decode_tet(tl2, lo, per):
    """Global slot tets from a shard's mega tets: settled (local id),
    escaped (``-(local+1)``) or paused (the sentinel ``-(per+g+1)``)."""
    escaped = (tl2 < 0) & (tl2 >= -per)
    return torch.where(tl2 >= 0, tl2 + lo, torch.where(escaped, tl2 - lo, -tl2 - per - 1))


def _local_cycle_cx(rows, nbrs, bd_esc, shard_id, per, pos, vel, disp, tet, act, res, pid,
                    seed, step, cfg, dt):
    """The ConvexPoly shard tracer (JAX ``_local_cycle_cx``, torch ops): the
    single-device convex path's trace and reflection on the shard's planes,
    the inlet face suppressed by its came-from code.  A hop into a remote
    tet pauses the trace: the lane keeps its march point in ``pos`` and the
    rest of its segment in ``disp``, migrates, and settles next cycle on
    the destination shard.  Escape patches deactivate in the bounce loop;
    the ``convex_bary_fix`` pass is not applied (it needs the bary tables)."""
    lo = shard_id * per
    n_bd = bd_esc.shape[0]
    C = pos.shape[0]
    lane = torch.arange(C, device=pos.device)
    no_inlet = -(2 ** 30)
    nbrs = nbrs.to(torch.int64)
    tet = tet.to(torch.int64)

    def in_shard(g):
        return (g >= lo) & (g < lo + per)

    def local(table, g):
        return table[(g - lo).clamp(0, per - 1)]

    def trace(p0, p_end, tet0, act_mask):
        """March p0 -> p_end; pauses at remote hops and walls.  Returns
        (p0', tet', wall, wall slot, remote)."""
        tet_c = tet0
        inlet = torch.full_like(tet0, no_inlet)
        done = ~act_mask | (tet0 < 0) | ~in_shard(tet0)
        wall = torch.zeros_like(done)
        slot_w = torch.zeros_like(tet0)
        for _ in range(cfg.max_hops):
            if bool(done.all()):
                break
            safe = tet_c.clamp(min=0)
            rl = local(rows, safe)
            nbr4 = local(nbrs, safe)
            dt_, slot = convex_ops._exit_face_tables(
                rl[:, 0:12].reshape(-1, 4, 3), rl[:, 12:16], p0, p_end - p0,
                nbr4 == inlet[:, None])
            stepping = ~done & (slot >= 0)
            code = nbr4[lane, slot.clamp(min=0)]
            p0 = torch.where(stepping[:, None], p0 + dt_[:, None] * (p_end - p0), p0)
            wall_new = stepping & (code < 0)
            remote = stepping & (code >= 0) & ~in_shard(code)
            moved = stepping & (code >= 0)
            inlet = torch.where(moved, tet_c, inlet)
            tet_c = torch.where(moved, code, tet_c)
            slot_w = torch.where(wall_new, slot, slot_w)
            done = done | (~done & (slot < 0)) | wall_new | remote
            wall = wall | wall_new
        remote = act_mask & (tet_c >= 0) & ~in_shard(tet_c) & ~wall
        return p0, tet_c, wall & act_mask, slot_w, remote

    def resolve(p_start, dvec, tet0, act_mask, vel):
        """Trace + reflect (at most MAX_BOUNCES mirrors, re-tracing after
        each).  Returns (pos, disp left, tet, vel, killed)."""
        p_end = p_start + dvec
        p0, tet2, wall, slot_w, remote = trace(p_start, p_end, tet0, act_mask)
        killed = torch.zeros_like(act_mask)
        for _ in range(convex_ops.MAX_BOUNCES):
            if not bool(wall.any()):
                break
            safe = tet2.clamp(min=0)
            rl = local(rows, safe)
            nbr4 = local(nbrs, safe)
            sw = slot_w.clamp(min=0)
            code_w = nbr4[lane, sw]
            bd = (-code_w - 1).clamp(0, n_bd - 1)
            esc = wall & (code_w < 0) & bd_esc[bd]
            tet2 = torch.where(esc, -(tet2 + 1), tet2)
            killed = killed | esc
            refl = wall & ~esc
            # mirror the segment end and the velocity across the hit plane
            nsel = rl[:, 0:12].reshape(-1, 4, 3)[lane, sw]
            dsel = rl[:, 12:16][lane, sw]
            pe = p_end - 2.0 * (convex_ops._dot3(p_end, nsel) - dsel)[:, None] * nsel
            un = vel - 2.0 * convex_ops._dot3(vel, nsel)[:, None] * nsel
            p_end = torch.where(refl[:, None], pe, p_end)
            vel = torch.where(refl[:, None], un, vel)
            p0n, tetn, walln, slotn, remoten = trace(p0, p_end, tet2.clamp(min=0), refl)
            p0 = torch.where(refl[:, None], p0n, p0)
            tet2 = torch.where(refl, tetn, tet2)
            slot_w = torch.where(refl, slotn, slot_w)
            remote = torch.where(refl, remoten, remote)
            wall = refl & walln
        settled = act_mask & ~remote & ~killed
        pos_new = torch.where(settled[:, None], p_end,
                              torch.where(remote[:, None], p0, p_start))
        disp_new = torch.where(remote[:, None], p_end - p0, torch.zeros_like(p0))
        return pos_new, disp_new, tet2, vel, killed

    # settle migrated arrivals: consume their pending displacement
    pend = res & act & (tet >= 0) & in_shard(tet) & (disp != 0.0).any(dim=1)
    pos_s, disp_s, tet_s, vel_s, kill_s = resolve(pos, disp, tet, pend, vel)
    pos = torch.where(pend[:, None], pos_s, pos)
    disp = torch.where(pend[:, None], disp_s, disp)
    tet = torch.where(pend, tet_s, tet)
    vel = torch.where(pend[:, None], vel_s, vel)
    act = act & ~kill_s

    # advect + Brownian (the reference cycle; lanes still in limbo skip it)
    live = res & act & (tet >= 0) & in_shard(tet) & ~(disp != 0.0).any(dim=1)
    u = local(rows, tet.clamp(min=0))[:, 20:23]
    dt_t, sigma = fused.scalars(cfg, dt, pos.dtype)
    zero = torch.zeros_like(pos)
    if cfg.use_advection:
        vel = torch.where(live[:, None], u, vel)
        dnew = torch.where(live[:, None], u * dt_t, zero)
    else:
        dnew = zero
    if cfg.use_brownian:
        xi = _pid_noise(seed, step, pid, cfg, pos.dtype)
        dnew = dnew + torch.where(live[:, None], sigma * xi, zero)
    if cfg.use_advection:
        act = act & ((tet >= 0) | ~res)
    pos_n, disp_n, tet_n, vel_n, kill_n = resolve(pos, dnew, tet, live, vel)
    pos = torch.where(live[:, None], pos_n, pos)
    disp = torch.where(live[:, None], disp_n, disp)
    tet = torch.where(live, tet_n, tet)
    vel = torch.where(live[:, None], vel_n, vel)
    act = act & ~kill_n
    return pos, vel, disp, tet.to(torch.int32), act


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------


def _admission(dest, leaving, res, devices):
    """The two-phase admission over every shard: each sender's request per
    destination, each receiver's grant per source (its free slots
    water-filled over the senders in source order), exchanged back.
    Returns (onehot [S, C] per shard: lane c leaves for shard d, admit [S]
    per receiver = rows it takes from each source, grant [S] per sender =
    rows each destination takes from it).  The one-hot is destination-major
    so that its scans run along the lanes (a scan over the outer dimension
    of a [C, S] array runs one thread per column on the card)."""
    S = len(dest)
    onehot, req = [], []
    for s in range(S):
        ar = torch.arange(S, device=dest[s].device)
        oh = (ar[:, None] == dest[s][None, :]) & leaving[s][None, :]
        onehot.append(oh)
        req.append(oh.sum(dim=1, dtype=torch.int64))
    req_in = all_to_all(req, devices)
    admit = []
    for d in range(S):
        my_free = (~res[d]).sum(dtype=torch.int64)
        cum_prev = torch.cumsum(req_in[d], 0) - req_in[d]
        admit.append(torch.minimum((my_free - cum_prev).clamp(min=0), req_in[d]))
    return onehot, admit, all_to_all(admit, devices)


def _fits(onehot, leaving, dest, grant, cap_out):
    """Leaving lanes that fit: rank within their destination group below
    both cap_out and the destination's grant (``onehot`` [S, C])."""
    S = onehot.shape[0]
    ranks = torch.cumsum(onehot.to(torch.int64), 1) - 1
    lane_rank = torch.where(onehot, ranks, torch.zeros_like(ranks)).sum(dim=0)
    return leaving & (lane_rank < cap_out) & (lane_rank < grant[dest.clamp(0, S - 1)])


def _pack_send(payloads, fits, dest, grant, cap_out):
    """The [S, cap_out, W] send buffers of one shard (one per payload
    [C, W]): rows grouped by destination in lane order (a stable sort, then
    a gather), zero past each group's count."""
    S = grant.shape[0]
    C = fits.shape[0]
    dev = fits.device
    key = torch.where(fits, dest, torch.full_like(dest, S))
    perm_sorted = torch.sort(key, stable=True).indices
    sent = torch.minimum(grant, torch.full_like(grant, cap_out))
    offset = torch.cumsum(sent, 0) - sent
    r_io = torch.arange(cap_out, device=dev)[None, :].expand(S, cap_out)
    src = perm_sorted[(offset[:, None] + r_io).clamp(0, C - 1)].reshape(-1)
    valid = (r_io < sent[:, None]).reshape(-1)
    return [torch.where(valid[:, None], p[src], torch.zeros_like(p[src])).reshape(S, cap_out, -1)
            for p in payloads]


def _placement(res, admit, cap_out):
    """(placed [C], recv row [C]) of a receiver: free slot #k takes valid
    received row #k, found by a cumsum search over the per-source counts
    (min(admit, cap_out) rows from each source, in source order)."""
    S = admit.shape[0]
    chunk_n = torch.minimum(admit, torch.full_like(admit, cap_out))
    cum = torch.cumsum(chunk_n, 0)
    n_recv = cum[S - 1]
    free = ~res
    fs_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    placed = free & (fs_rank < n_recv)
    k = torch.minimum(fs_rank.clamp(min=0), (n_recv - 1).clamp(min=0))
    s_of_k = (k[:, None] >= cum[None, :]).sum(dim=1)
    base = torch.where(s_of_k > 0, cum[(s_of_k - 1).clamp(0, S - 1)], torch.zeros_like(k))
    recv_idx = s_of_k * cap_out + (k - base)
    return placed, torch.where(placed, recv_idx, torch.zeros_like(recv_idx))


def _migrate(pos, vel, disp, tet, act, res, pid, per, devices, cap_out):
    """The fixed-capacity exchange of the slots owned by other shards (JAX
    ``_migrate``), over per-shard lists.  Loss-free: a sender respects each
    receiver's grant; lanes over it stay resident and retry next cycle.
    Returns the new lists and the (migrated, deferred) counts on the first
    device."""
    S = len(pos)
    dest, leaving = [], []
    for s in range(S):
        d_ = torch.where((tet[s] >= 0) & res[s], torch.div(tet[s], per, rounding_mode="floor"),
                         torch.full_like(tet[s], s)).long()
        dest.append(d_)
        leaving.append(res[s] & (d_ != s))
    onehot, admit, grant = _admission(dest, leaving, res, devices)
    send_f, send_i, fits = [], [], []
    for s in range(S):
        with on_device(devices[s]):
            f = _fits(onehot[s], leaving[s], dest[s], grant[s], cap_out)
            fits.append(f)
            pf = torch.cat([pos[s], vel[s], disp[s], act[s][:, None].to(pos[s].dtype)], dim=1)
            pi = torch.stack([tet[s].long(), pid[s].long()], dim=1)
            a, b = _pack_send([pf, pi], f, dest[s], grant[s], cap_out)
            send_f.append(a)
            send_i.append(b)
    recv_f, recv_i = all_to_all(send_f, devices), all_to_all(send_i, devices)
    out = [list(x) for x in (pos, vel, disp, tet, act, res, pid)]
    migrated = deferred = 0
    for d in range(S):
        with on_device(devices[d]):
            r = res[d] & ~fits[d]
            placed, idx = _placement(r, admit[d], cap_out)
            sf = recv_f[d].reshape(S * cap_out, -1)[idx]
            si = recv_i[d].reshape(S * cap_out, -1)[idx]
            pm3 = placed[:, None]
            out[0][d] = torch.where(pm3, sf[:, 0:3], pos[d])
            out[1][d] = torch.where(pm3, sf[:, 3:6], vel[d])
            out[2][d] = torch.where(pm3, sf[:, 6:9], disp[d])
            out[3][d] = torch.where(placed, si[:, 0].to(tet[d].dtype), tet[d])
            out[4][d] = torch.where(placed, sf[:, 9] > 0.5, act[d])
            out[5][d] = r | placed
            out[6][d] = torch.where(placed, si[:, 1].to(pid[d].dtype), pid[d])
            migrated = migrated + fits[d].sum().to(devices[0])
            deferred = deferred + (leaving[d] & ~fits[d]).sum().to(devices[0])
    return (*out, migrated, deferred)


def _migrate_mega(ctxs, m, act, res, pid, per, devices, cap_out, movers=None):
    """:func:`_migrate` on resident mega rows (JAX ``_migrate_mega``): the
    payload is the mega head ``[pos | vel | global tet | act]`` and the
    pid; arrivals are re-packed against the DESTINATION shard's table (one
    cap_out-row gather) before the placement; every remote-coded lane's
    ACT column is zeroed (sent slots become free, deferred lanes idle in
    limbo).  ``movers`` (a mask per shard): only those remote-coded lanes
    leave.  In place on the lists; returns (migrated, deferred, the slots
    each shard filled)."""
    S = len(m)
    dest, leaving, g = [], [], []
    for s in range(S):
        tl = m[s][:, TET].to(torch.int64)
        lv = res[s] & (tl < -per)
        if movers is not None:
            lv = lv & movers[s]
        gs = -tl - per - 1
        dest.append(torch.where(lv, torch.div(gs, per, rounding_mode="floor"),
                                torch.full_like(gs, s)))
        leaving.append(lv)
        g.append(gs)
    onehot, admit, grant = _admission(dest, leaving, res, devices)
    send_f, send_i, fits = [], [], []
    for s in range(S):
        with on_device(devices[s]):
            f = _fits(onehot[s], leaving[s], dest[s], grant[s], cap_out)
            fits.append(f)
            head = m[s][:, :ROW].clone()
            head[:, TET] = g[s].to(head.dtype)
            head[:, ACT] = act[s].to(head.dtype)
            a, b = _pack_send([head, pid[s].long()[:, None]], f, dest[s], grant[s], cap_out)
            send_f.append(a)
            send_i.append(b)
    recv_f, recv_i = all_to_all(send_f, devices), all_to_all(send_i, devices)
    migrated = deferred = 0
    filled = []
    for d in range(S):
        with on_device(devices[d]):
            ctx, md = ctxs[d], m[d]
            lo = d * per
            r = res[d] & ~fits[d]
            md[:, ACT] = torch.where(leaving[d], torch.zeros_like(md[:, ACT]), md[:, ACT])
            rf = recv_f[d].reshape(S * cap_out, ROW)
            rtl = (rf[:, TET].to(torch.int64) - lo).clamp(0, per - 1)
            arr = torch.zeros((S * cap_out, ctx.ly.width), dtype=md.dtype, device=md.device)
            arr[:, :ROW] = rf
            arr[:, TET] = rtl.to(md.dtype)
            arr[:, ROW : ROW + ctx.ly.tab_w] = ctx.tab[rtl]
            placed, idx = _placement(r, admit[d], cap_out)
            staged = arr[idx]
            md.copy_(torch.where(placed[:, None], staged, md))
            act[d] = torch.where(placed, staged[:, ACT] > 0.5, act[d])
            pid[d] = torch.where(placed, recv_i[d].reshape(S * cap_out)[idx].to(pid[d].dtype),
                                 pid[d])
            res[d] = r | placed
            filled.append(placed)
            migrated = migrated + fits[d].sum().to(devices[0])
            deferred = deferred + (leaving[d] & ~fits[d]).sum().to(devices[0])
    return migrated, deferred, filled


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _cap_out(capacity, cap_out_frac):
    return max(int(capacity * cap_out_frac), 16)


def make_partitioned_step(pm: PartitionedMesh, cfg: StepConfig, devices=None,
                          cap_out_frac: float = 0.25):
    """The partitioned step from slot arrays: ``step(pm, sp, dt) -> (sp,
    {"migrated", "deferred"})`` (counts as tensors on the first device).
    The bary and Pk layouts encode the slots, run one :class:`MegaShards`
    cycle and decode (JAX packs its per-cycle step the same way, and its
    runner equals its step loop); ConvexPoly runs every shard's
    :func:`_local_cycle_cx`, then one :func:`_migrate` round."""
    S, per = pm.n_shards, pm.tets_per_shard
    if not (pm.layout == "cx" and cfg.locate_mode == "convex"):
        def step(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
            devs = devices if devices is not None else [p.device for p in sp.pos]
            mega = MegaShards(pmesh, cfg, devs, sp, cap_out_frac)
            stats = mega.cycles(1, dt)
            return mega.decode(), stats

        return step

    def step(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
        devs = devices if devices is not None else [p.device for p in sp.pos]
        cols = [[], [], [], [], []]
        for s in range(S):
            with on_device(devs[s]):
                out = _local_cycle_cx(pmesh.tet_row[s], pmesh.tet_nbr[s], pmesh.bd_escape[s], s,
                                      per, sp.pos[s], sp.vel[s], sp.disp[s], sp.tet[s],
                                      sp.active[s], sp.resident[s], sp.pid[s], sp.seed, sp.step,
                                      cfg, dt)
                for c, x in zip(cols, out):
                    c.append(x)
        pos, vel, disp, tet, act = cols
        *slots, migrated, deferred = _migrate(
            pos, vel, disp, tet, act, sp.resident, sp.pid, per, devs,
            _cap_out(sp.capacity, cap_out_frac))
        pos, vel, disp, tet, act, res, pid = slots
        return (dataclasses.replace(sp, pos=pos, vel=vel, disp=disp, tet=tet, active=act,
                                    resident=res, pid=pid, step=sp.step + 1),
                {"migrated": migrated, "deferred": deferred})

    return step


SETTLE_ROUNDS = 4   # migration rounds a cycle's settle may take (module docstring)


class MegaShards:
    """The mega-resident partitioned run (JAX ``make_partitioned_runner_mega``,
    its scan body one :meth:`cycles` iteration): every slot encoded into its
    shard's packed mega once (settled lanes -> local tet, limbo lanes -> the
    remote sentinel with ACT 0, escaped lanes -> the shard-local exit code),
    the settle + cycle core per sub-step with migration exchanged directly
    on mega rows (:func:`_migrate_mega`), and :meth:`decode` back to slot
    arrays.  The ``act``/``res``/``pid`` side arrays stay authoritative
    (the mega ACT column only gates the engine).  Kept across calls by the
    engine.

    **Settle rounds (a difference from JAX).**  Slab boundaries are jagged
    (tets sorted by centroid), so the settle walk of an arrival can meet a
    tet of yet another slab, or of the one it came from, and pause again.
    JAX's cycle then runs the stream on that lane with its sentinel tet:
    the advect kill reads it as dead, and the particle is lost (on the
    north-star slice with 4 slabs, about 40 lanes a cycle).  Here such lanes
    migrate again at once and settle on their new shard, up to
    ``SETTLE_ROUNDS`` rounds (one host read of the paused count a round),
    so that every arrival sits in its tet before the advect, as on one
    device; a lane still paused after that, or deferred, idles this cycle
    in limbo and keeps its ``act``.  Where no settle pauses (every case of
    JAX's own tests) the run is JAX's, bit for bit."""

    def __init__(self, pm: PartitionedMesh, cfg: StepConfig, devices,
                 sp: ShardedParticles, cap_out_frac: float = 0.25):
        self.pm, self.cfg, self.devices, self.sp = pm, cfg, list(devices), sp
        S, per = pm.n_shards, pm.tets_per_shard
        self.cap_out = _cap_out(sp.capacity, cap_out_frac)
        self.seed, self.step = sp.seed, sp.step
        self.ctxs, self.m, self.pending = [], [], []
        self.act, self.res, self.pid = list(sp.active), list(sp.resident), list(sp.pid)
        for s in range(S):
            with on_device(self.devices[s]):
                ctx = _CachedCtx(pm.tet_row[s], pm.bd_escape[s], per, cfg)
                lo = s * per
                tet, res = sp.tet[s], sp.resident[s]
                in_sh = (tet >= lo) & (tet < lo + per)
                # an empty slot enters with tet -1 (JAX's 0), so it never
                # walks; nothing reads it before an arrival overwrites it
                tl0 = torch.where(~res, torch.full_like(tet, -1), torch.where(
                    in_sh & (tet >= 0), tet - lo,
                    torch.where(tet >= 0, -(per + tet + 1), tet + lo)))
                live0 = res & sp.active[s] & in_sh & (tet >= 0)
                self.ctxs.append(ctx)
                self.m.append(ctx.pack(sp.pos[s], sp.vel[s], tl0, live0))
                self.pending.append(torch.empty(tet.shape[0], dtype=torch.uint8,
                                                device=tet.device))

    def cycles(self, n_cycles: int, dt) -> dict:
        """``n_cycles`` sub-steps, each the settle (and its rounds) and the
        cycle on every shard, then one migration round; returns the summed
        counts (tensors)."""
        cfg, per, S = self.cfg, self.pm.tets_per_shard, self.pm.n_shards
        migrated = deferred = 0
        rounds = 0
        for i in range(n_cycles):
            stepc = self.step + i
            pre_tl, live_pre = [], []
            for s in range(S):
                with on_device(self.devices[s]):
                    m = self.m[s]
                    tl = m[:, TET].to(torch.int64)
                    # a lane that escaped last cycle keeps act until the
                    # advect kill below, but neither advects nor settles
                    live = (m[:, ACT] > 0.5) & (tl >= 0)
                    m[:, ACT] = torch.where(live, m[:, ACT], torch.zeros_like(m[:, ACT]))
                    pre_tl.append(tl)
                    live_pre.append(live)
            for r in range(SETTLE_ROUNDS + 1):
                paused = []
                for s, ctx in enumerate(self.ctxs):
                    with on_device(self.devices[s]):
                        _settle(ctx, self.m[s], self.pending[s])
                        paused.append(live_pre[s] & self.res[s]
                                      & (self.m[s][:, TET] < -per))
                if S == 1 or r == SETTLE_ROUNDS or not int(sum(
                        p.sum().to(self.devices[0]) for p in paused)):
                    break
                mig, defr, filled = _migrate_mega(self.ctxs, self.m, self.act, self.res,
                                                  self.pid, per, self.devices, self.cap_out,
                                                  movers=paused)
                migrated, deferred, rounds = migrated + mig, deferred + defr, rounds + 1
                for s in range(S):
                    # an arrival was live at the cycle's start on its sender
                    live_pre[s] = (live_pre[s] & self.res[s]) | filled[s]
                    pre_tl[s] = torch.where(filled[s], self.m[s][:, TET].to(torch.int64),
                                            pre_tl[s])
            for s, ctx in enumerate(self.ctxs):
                with on_device(self.devices[s]):
                    m = self.m[s]
                    # lanes still paused (or deferred) after the settle idle in limbo
                    live = live_pre[s] & (m[:, TET] >= -per)
                    noise = _pid_noise(self.seed, stepc, self.pid[s], cfg, m.dtype)
                    _cycle(ctx, m, noise, dt, self.pending[s])
                    act = torch.where(live, m[:, ACT] > 0.5, self.act[s])
                    if cfg.use_advection:
                        # advect kill by the pre-cycle location: escaped-coded
                        # lanes die, settled and limbo lanes live
                        tl = pre_tl[s]
                        act = act & ((tl >= 0) | (tl < -per) | ~self.res[s])
                        m[:, ACT] = m[:, ACT] * act.to(m.dtype)
                    self.act[s] = act
            mig, defr, _ = _migrate_mega(self.ctxs, self.m, self.act, self.res, self.pid, per,
                                         self.devices, self.cap_out)
            migrated, deferred = migrated + mig, deferred + defr
        self.step += n_cycles
        return {"migrated": migrated, "deferred": deferred, "settle_rounds": rounds}

    def decode(self) -> ShardedParticles:
        """The slot arrays of the current state (the resident run goes on)."""
        per, sp = self.pm.tets_per_shard, self.sp
        cols = [[], [], [], []]
        for s in range(self.pm.n_shards):
            with on_device(self.devices[s]):
                pos2, vel2, tl2, _ = fused.unpack_state(self.m[s])
                res = self.res[s]
                tet_g = _decode_tet(tl2, s * per, per)
                cols[0].append(torch.where(res[:, None], pos2, sp.pos[s]))
                cols[1].append(torch.where(res[:, None], vel2, sp.vel[s]))
                cols[2].append(torch.where(res, tet_g, sp.tet[s]))
                cols[3].append(torch.zeros_like(sp.pos[s]))
        return dataclasses.replace(
            sp, pos=cols[0], vel=cols[1], disp=cols[3], tet=cols[2], active=list(self.act),
            resident=list(self.res), pid=list(self.pid), step=self.step)


def make_partitioned_runner_mega(pm: PartitionedMesh, cfg: StepConfig, devices,
                                 n_cycles: int, cap_out_frac: float = 0.25):
    """``n_cycles`` partitioned steps on resident megas (:class:`MegaShards`):
    ``run(pm, sp, dt) -> (sp, {"migrated", "deferred"})``."""

    def run(pmesh: PartitionedMesh, sp: ShardedParticles, dt):
        devs = devices if devices is not None else [p.device for p in sp.pos]
        mega = MegaShards(pmesh, cfg, devs, sp, cap_out_frac)
        stats = mega.cycles(n_cycles, dt)
        return mega.decode(), stats

    return run


def make_partitioned_runner(pm: PartitionedMesh, cfg: StepConfig, devices, n_cycles: int,
                            cap_out_frac: float = 0.25):
    """``n_cycles`` partitioned steps: the mega-resident runner for the
    bary / Pk layouts, a loop of :func:`make_partitioned_step` for
    ConvexPoly; both give the same trajectories (JAX pins that with
    ``test_partitioned_runner_matches_step_loop``)."""
    if pm.layout == "cx" and cfg.locate_mode == "convex":
        step = make_partitioned_step(pm, cfg, devices, cap_out_frac)

        def run(pmesh, sp, dt):
            migrated = deferred = 0
            for _ in range(n_cycles):
                sp, st = step(pmesh, sp, dt)
                migrated, deferred = migrated + st["migrated"], deferred + st["deferred"]
            return sp, {"migrated": migrated, "deferred": deferred}

        return run
    return make_partitioned_runner_mega(pm, cfg, devices, n_cycles, cap_out_frac)


def make_settle_step(pm: PartitionedMesh, cfg: StepConfig, devices=None):
    """A displacement-free step (no advection, no Brownian term) that
    finishes pending hand-offs: run before collecting, so that snapshots
    match the single-device trajectory (hand-offs otherwise lag a cycle)."""
    return make_partitioned_step(
        pm, dataclasses.replace(cfg, use_advection=False, use_brownian=False), devices)
