"""Row-cached fused sub-step (port of ``cudaparticlesfoam_tpu/ops/fused.py``,
TetVelocity and VertexVelocity layouts).

All per-particle data lives in ONE row-major mega array, a :class:`Layout`
per interpolation mode.  TetVelocity (``LAYOUT_TET``): ``[n, 32]`` (128 B
per lane in float32): 0:3 pos | 3:6 vel | 6 tet (exact float integer) |
7 active | 8:28 the lane's cached tet row (``mesh.tet_row``) | 28:32 pad.
VertexVelocity (``LAYOUT_PK``): ``[n, 40]``: the same head | 8:37 the
lane's cached ``mesh.tet_row_pk`` row | 37:40 pad, equal to the JAX
package's Pk mega element for element.  The row table the Pk cycle reads
is ``mesh.tet_row_pk32``, the same rows padded to 32 columns where the
mesh uploads them (:func:`row_table`), so that a table row is one 128 B
line in float32 and every row starts on a 16 B boundary: columns 8:40 of
a Pk mega row are one such padded row.

One cycle is two kernels (``ops/fused_cuda.py``):

1. **stream** (K1 + K2): advect, Brownian kick, tentative move, hop-0
   barycentric test on the cached row, up to ``inline_hops`` face hops
   (each mover loads its neighbour's row), then the inline single bounce
   or an absorb through the row's escape mask.  Lanes still unresolved
   (deeper walkers, multi-bounce wall hits) get a pending flag.
2. **rare** (K7): each pending lane runs the bounded walk and the
   multi-bounce specular reflection (``baryTetSearch`` + ``RTreflection``,
   ``RTQuery.cu:35-186``).  The JAX package compacts pending lanes into
   blocks first; that only affects speed (each pending lane is resolved
   exactly once), so the port runs the kernel over all lanes and returns
   early where the flag is 0.

Three settings change the cycle:

* ``hop_compact=4`` (K3, the block-compacted hop gather): the stream runs
  in two passes around ``hop_admit_kernel``, which admits 4-lane groups
  and ranks as ``_compact_hop_rows`` does; a crosser it skips goes
  pending with its pre-hop tet (:func:`mega_cycle`).
* ``macro_cycles`` = k (K4): k sub-steps per pass over the mega, as k
  trips of ``macro_stream_kernel`` + the rare kernel (:func:`mega_macro`).
* ``integrator="rk4"``: the stream kernel's RK4 instantiation, each stage
  velocity from a walk of the stage point inside the kernel
  (:func:`stage_velocity`; JAX's ``_stage_velocity``, XLA code).

:func:`stream_plain`, :func:`rare_plain`, :func:`hop_admit_plain` and
:func:`macro_stream_plain` are the plain PyTorch versions of the kernels.
They copy ``fused._mega_cycle_aligned`` (``fused.py:616-790``) and
``_make_run_lanes`` / ``_walk_mega`` / ``_reflect_mega`` expression for
expression (same association order, first-minimum argmin with strict
'<', the masked reciprocal of the inline bounce), so on the CPU they are
what the tests compare with the JAX package, and on the card what the
kernels are compared with.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dtypes import numpy_float
from ..mesh import TetMesh
from .advect import VERTEX_VELOCITY
from .locate import MAX_HOPS

# mega-row column offsets
P0, V0, TET, ACT, ROW = 0, 3, 6, 7, 8


@dataclasses.dataclass(frozen=True)
class Layout:
    """Row-table geometry for one interpolation mode."""

    row_w: int    # mesh table row width (the escape mask is its last column)
    width: int    # mega-row width
    vel: int      # row-offset of the velocity payload (u, or v0..v3)
    nbr: int      # row-offset of the 4 neighbour codes
    tab_w: int    # row width of :func:`row_table`, the row block a hop moves

    @property
    def esc(self) -> int:
        """Row column of the 4-bit escape mask."""
        return self.row_w - 1


LAYOUT_TET = Layout(row_w=20, width=32, vel=12, nbr=15, tab_w=20)
LAYOUT_PK = Layout(row_w=29, width=40, vel=12, nbr=24, tab_w=32)


def layout_for(cfg) -> Layout:
    """The layout of ``cfg.velocity_interp`` (JAX ``fused.layout_for``)."""
    return LAYOUT_PK if cfg.velocity_interp == VERTEX_VELOCITY else LAYOUT_TET


def row_table(mesh: TetMesh, ly: Layout = LAYOUT_TET) -> torch.Tensor:
    """The table [nt, ly.tab_w] a cycle under ``ly`` reads: ``mesh.tet_row``,
    or ``mesh.tet_row_pk32`` (``tet_row_pk`` padded with zeros to 32
    columns, stored once by the mesh)."""
    if ly is LAYOUT_TET:
        return mesh.tet_row
    if mesh.tet_row_pk32 is None:
        raise ValueError("the VertexVelocity cached engine needs mesh.with_pk_rows(mesh)")
    return mesh.tet_row_pk32


def pack_state(tab, pos, vel, tet_id, active, width: int = LAYOUT_TET.width) -> torch.Tensor:
    """Build the [n, width] mega array (one ``tab`` gather for the cache):
    pos, vel, tet (as a float) and active (0 or 1) at columns 0:8, the
    lane's row of ``tab`` [nt, tw] at 8:8+tw (row 0 for a negative tet) and
    zeros after it.  ``tab`` is :func:`row_table`'s (width ``ly.width``) or
    the convex ``cx_table`` (width 32).  The plain version of
    ``pack_kernel`` (``csrc/pack.cu``): ``fused_cuda.pack_rows`` runs this
    on CPU tensors and the kernel on CUDA tensors."""
    n = pos.shape[0]
    m = torch.zeros((n, width), dtype=pos.dtype, device=pos.device)
    m[:, P0 : P0 + 3] = pos
    m[:, V0 : V0 + 3] = vel
    m[:, TET] = tet_id.to(pos.dtype)
    m[:, ACT] = active.to(pos.dtype)
    m[:, ROW : ROW + tab.shape[1]] = tab[tet_id.long().clamp(min=0)]
    return m


def unpack_state(m: torch.Tensor):
    """(pos, vel, tet_id int32, active bool) views/copies of the mega."""
    return m[:, P0 : P0 + 3], m[:, V0 : V0 + 3], m[:, TET].to(torch.int32), m[:, ACT] > 0.5


RBG_MODES = ("rbg", "rbg_kernel")
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox_key(seed: int, step: int, lane_offset: int = 0) -> tuple:
    """The 4 uint32 words of the JAX "rbg" stream's key for one sub-step
    (``fused._brownian_noise``): ``[key0, key1, 0x9E3779B9 ^ lane_offset,
    step]`` with (key0, key1) = ``jax.random.PRNGKey(seed)`` =
    (seed >> 32, seed & 0xffffffff)."""
    seed = int(seed)
    return ((seed >> 32) & _MASK32, seed & _MASK32,
            (0x9E3779B9 ^ int(lane_offset)) & _MASK32, int(step) & _MASK32)


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit halves of m * x for x in [0, 2^32) as int64, with no
    int64 overflow (x split into 16-bit halves)."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    s = a + ((b & 0xFFFF) << 16)
    return (s >> 32) + (b >> 16), s & _MASK32


def philox_bits(key4, n: int, device=None, lanes=None) -> torch.Tensor:
    """uint32 words [n, 4] (held in int64) equal to XLA's Philox4x32-10
    ``lax.rng_bit_generator(key4, (n, 4), uint32)``, the off-TPU JAX "rbg"
    stream: Philox key (key4[0], key4[1]); row l is the block of the
    128-bit counter ``(key4[1], key4[0], key4[3], key4[2]) + l`` (most
    significant word first), and its 4 output words in order.  ``lanes``
    (int64 [n], on ``device``): rows ``lanes`` of that stream instead of
    rows 0..n-1."""
    k0, k1, k2, k3 = (int(k) & _MASK32 for k in key4)
    lane = torch.arange(n, dtype=torch.int64, device=device) if lanes is None else lanes
    c = []
    carry = lane
    for w in (k2, k3, k0, k1):          # counter words, least significant first
        s = carry + w
        c.append(s & _MASK32)
        carry = s >> 32
    key = [torch.full_like(lane, k0), torch.full_like(lane, k1)]
    for r in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ key[0], lo1, hi0 ^ c[3] ^ key[1], lo0]
        key = [(key[0] + _PHILOX_W[0]) & _MASK32, (key[1] + _PHILOX_W[1]) & _MASK32]
    return torch.stack(c, dim=1)


def philox_normals(key4, n: int, dtype, device=None, lanes=None) -> torch.Tensor:
    """Standard normals [n, 3] of the JAX "rbg" stream: u = bits * 2^-32 +
    2^-33 in ``dtype``, then full-pair Box-Muller, 3 normals from 4
    uniforms (``fused.py:187-201``).  ``lanes``: as :func:`philox_bits`."""
    bits = philox_bits(key4, n, device, lanes)
    u = bits.to(dtype) * (1.0 / 4294967296.0) + (0.5 / 4294967296.0)
    two_pi = torch.tensor(2.0 * np.pi, dtype=dtype, device=device)
    r = torch.sqrt(-2.0 * torch.log(u[:, :2]))
    a = two_pi * u[:, 2:4]
    return torch.stack([r[:, 0] * torch.cos(a[:, 0]), r[:, 0] * torch.sin(a[:, 0]),
                        r[:, 1] * torch.cos(a[:, 1])], dim=1)


def _stream_seed(seed: int, step: int, device) -> int:
    """Generator seed of the (seed, step) threefry-mode stream, below 2^63.
    On the card ``seed`` in the high and ``step`` in the low 32 bits: its
    generator takes all 64.  torch's CPU generator keeps only the low 32
    bits of its seed, so there a splitmix64 hash of the pair, whose halves
    both depend on ``seed`` and on ``step``."""
    if torch.device(device).type != "cpu":
        return ((int(seed) << 32) + int(step)) % (1 << 63)
    m = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 0x632BE59BD9B4E019) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) >> 1


def _brownian_noise(seed: int, step: int, n: int, dtype, device,
                    mode: str = "threefry") -> torch.Tensor:
    """Per-cycle standard-normal noise [n, 3].

    * ``"threefry"``: a ``torch.Generator`` on ``device`` seeded from
      (seed, step), one stream per sub-step like the JAX package's
      ``fold_in(key, step)``; the bits differ from JAX's threefry stream,
      so parity tests inject their noise instead.
    * ``"rbg"`` / ``"rbg_kernel"``: :func:`philox_normals` of
      :func:`philox_key` (seed, step), the same bits as the JAX "rbg"
      stream off a TPU; the CUDA stream kernels draw the same stream in
      the kernel (``csrc/philox.cuh``)."""
    if mode in RBG_MODES:
        return philox_normals(philox_key(seed, step), n, dtype, device)
    if mode != "threefry":
        raise ValueError(f"unknown brownian_rng {mode!r}")
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(seed, step, device))
    return torch.randn((n, 3), generator=g, dtype=dtype, device=device)


def scalars(cfg, dt, dtype) -> tuple[float, float]:
    """(dt, sigma) rounded to the state dtype as the JAX package forms
    them: dt cast first, sigma = sqrt(T(2 D) * T(dt)) in T."""
    nt = numpy_float(dtype)
    dt_t = np.asarray(dt, nt)
    sigma = np.sqrt(np.asarray(2.0 * cfg.diffusion_coeff, nt) * dt_t)
    return float(dt_t), float(sigma)


# ---------------------------------------------------------------------------
# column helpers (same expressions as fused.py)
# ---------------------------------------------------------------------------


def _bary(rows, px, py, pz):
    """Barycentric components against table rows (A 0:3, Tinv 3:12 in
    every layout)."""
    rx = px - rows[:, 0]
    ry = py - rows[:, 1]
    rz = pz - rows[:, 2]
    wb = rows[:, 3] * rx + rows[:, 4] * ry + rows[:, 5] * rz
    wc = rows[:, 6] * rx + rows[:, 7] * ry + rows[:, 8] * rz
    wd = rows[:, 9] * rx + rows[:, 10] * ry + rows[:, 11] * rz
    wa = 1.0 - wb - wc - wd
    return wa, wb, wc, wd


def _argmin4(wa, wb, wc, wd):
    """First-minimum argmin (owl arg_min scan semantics: strict '<')."""
    best = wa
    slot = torch.zeros(wa.shape, dtype=torch.int64, device=wa.device)
    for i, w in ((1, wb), (2, wc), (3, wd)):
        upd = w < best
        best = torch.where(upd, w, best)
        slot = torch.where(upd, torch.full_like(slot, i), slot)
    return slot, best


def _pick(cols, slot):
    """cols[:, slot] per lane (cols [n, 4])."""
    return cols.gather(1, slot[:, None])[:, 0]


def _pick4(w4, slot):
    return _pick(torch.stack(w4, dim=1), slot)


def _codes(rows, slot, ly=LAYOUT_TET):
    """Neighbour code of ``slot`` as int64 (exact float integers)."""
    nb = ly.nbr
    return _pick(rows[:, nb : nb + 4], slot).to(torch.int64)


def _grad(rows, slot):
    """Gradient of barycentric component ``slot``: row (slot-1) of Tinv,
    or -(sum of rows) for slot 0."""
    def comp(o):
        g0 = -(rows[:, 3 + o] + rows[:, 6 + o] + rows[:, 9 + o])
        return _pick(torch.stack([g0, rows[:, 3 + o], rows[:, 6 + o],
                                  rows[:, 9 + o]], dim=1), slot)

    return comp(0), comp(1), comp(2)


# ---------------------------------------------------------------------------
# K1 + K2: the stream (plain version of csrc/stream.cu)
# ---------------------------------------------------------------------------


def _lane_start(m, use_adv):
    """(tet int64, alive, alf, actf) of each lane at the start of a cycle;
    actf is the active column the cycle writes (the advect kill,
    particles.cu:333-338)."""
    tet = m[:, TET].to(torch.int64)
    act = m[:, ACT] > 0.5
    alive = (act & (tet >= 0)) if use_adv else act
    alf = alive.to(m.dtype)
    return tet, alive, alf, alf if use_adv else m[:, ACT]


def _row_velocity(rows, pos, ly=LAYOUT_TET):
    """The velocity (ux, uy, uz) at ``pos`` in ``rows``: the row's tet
    velocity, or under ``LAYOUT_PK`` the barycentric blend of its 4 vertex
    velocities at ``pos`` (``particles.cu:245-313``), associated
    ((w0 v0 + w1 v1) + w2 v2) + w3 v3 per component as the JAX package
    does."""
    RV = ly.vel
    if ly is LAYOUT_PK:
        w4 = _bary(rows, *pos)
        return tuple(((w4[0] * rows[:, RV + c] + w4[1] * rows[:, RV + 3 + c])
                      + w4[2] * rows[:, RV + 6 + c]) + w4[3] * rows[:, RV + 9 + c]
                     for c in range(3))
    return rows[:, RV], rows[:, RV + 1], rows[:, RV + 2]


def stage_velocity(tab, rows, tet, live, q, ly=LAYOUT_TET, walks=None):
    """Velocity at an RK4 stage point ``q`` = (qx, qy, qz) (plain version of
    ``stage_velocity`` in csrc/stream.cu; ``fused._stage_velocity``,
    ``fused.py:515-584``): the hop-0 barycentric test on the lane's cached
    ``rows``; a ``live`` lane that fails it walks from its cached tet and
    row with ``_walk_mega`` semantics (the default 50 hops, not
    ``cfg.max_hops``) and takes the velocity of the tet it ends in (in the
    domain, or out of hops); a walk that leaves the domain, and every lane
    that does not walk, keeps the own-row velocity at ``q`` (under
    ``LAYOUT_PK`` the own row's blend at ``q``: extrapolated weights).  The
    JAX package compacts the walkers into a sorted arena; the walk of a
    lane does not depend on the others, so the port takes them by index.
    ``walks`` (int64 [3]): adds the lanes that walked, the table rows
    their walks loaded, and the walks that left the domain."""
    k = _row_velocity(rows, q, ly)
    w4 = _bary(rows, *q)
    wmin = torch.minimum(torch.minimum(w4[0], w4[1]), torch.minimum(w4[2], w4[3]))
    idx = (live & (wmin < 0.0)).nonzero()[:, 0]
    chain = torch.zeros(idx.shape[0], dtype=torch.int64, device=rows.device)
    qi = tuple(c[idx] for c in q)
    act = torch.ones(idx.shape[0], dtype=torch.bool, device=rows.device)
    rows_w, code, _ = _walk(tab, rows[idx], tet[idx], *qi, act, MAX_HOPS, ly, chain)
    found = code >= 0
    k = tuple(kc.index_put((idx,), torch.where(found, sc, kc[idx]))
              for kc, sc in zip(k, _row_velocity(rows_w, qi, ly)))
    if walks is not None:
        walks[0] += idx.shape[0]
        walks[1] += chain.sum()
        walks[2] += (~found).sum()
    return k


def _sub_step(rows, pos, vel, alf, alive, xi, *, dt, sigma, use_adv, use_brown,
              ly=LAYOUT_TET, stage=None):
    """One sub-step's displacement (dx, dy, dz) and velocity (vx, vy, vz)
    from the cached rows, the lanes' position ``pos`` and velocity ``vel``
    (3 columns each) and the noise ``xi`` [n, 3] (read iff use_brown).
    The advecting velocity is :func:`_row_velocity` at the CURRENT
    position.  ``stage`` (j, q) -> velocity at stage point q makes it the
    classical RK4 step of ``fused._mega_cycle_aligned`` (``fused.py:
    630-650``): stages at p0 + dt/2 k1, p0 + dt/2 k2 and p0 + dt k3, then
    u = (((k1 + 2 k2) + 2 k3) + k4) / 6, in that association."""
    ux, uy, uz = _row_velocity(rows, pos, ly)
    if use_adv and stage is not None:
        half = 0.5 * dt
        k2 = stage(0, tuple(p + half * u for p, u in zip(pos, (ux, uy, uz))))
        k3 = stage(1, tuple(p + half * u for p, u in zip(pos, k2)))
        k4 = stage(2, tuple(p + dt * u for p, u in zip(pos, k3)))
        # a true division, as the kernel's: on CUDA, torch divides by a Python
        # scalar as a multiplication by its reciprocal
        six = torch.full((), 6.0, dtype=ux.dtype, device=ux.device)
        ux, uy, uz = ((((k1 + 2.0 * a) + 2.0 * b) + c) / six
                      for k1, a, b, c in zip((ux, uy, uz), k2, k3, k4))
    if use_adv:
        dx, dy, dz = alf * ux * dt, alf * uy * dt, alf * uz * dt
        # advected velocity into vel columns (particles.cu:361)
        vel = tuple(torch.where(alive, u, v) for u, v in zip((ux, uy, uz), vel))
    else:
        dx = dy = dz = torch.zeros_like(ux)
    if use_brown:
        dx = dx + alf * sigma * xi[:, 0]
        dy = dy + alf * sigma * xi[:, 1]
        dz = dz + alf * sigma * xi[:, 2]
    return (dx, dy, dz), vel


def _resolve(tab, rows, bw, s_cur, unresolved, tet, admit, pos, vel, actf, *,
             n_hops, bounce_on, esc_on, ly=LAYOUT_TET):
    """Everything after the hop-0 test (``resolve`` in
    csrc/stream.cuh): up to ``n_hops`` inline hops, a crosser whose
    ``admit`` flag is 0 skipping its first hop and staying pending with its
    cached row and pre-hop tet (``_b_compute_c`` with extra_pend), then the
    inline single bounce or absorb.  ``rows`` and ``tab`` are ``ly.tab_w``
    wide.  Returns (mega rows [n, ly.width], pending)."""
    T, dev = rows.dtype, rows.device
    px, py, pz = pos
    vx, vy, vz = vel
    cur_rows, cur_tet = rows, tet
    wall = torch.zeros_like(unresolved)
    wall_slot = torch.zeros_like(s_cur)
    skipped = torch.zeros_like(unresolved)

    # inline hops: each mover takes its neighbour's row
    for h in range(n_hops):
        code = _codes(cur_rows, s_cur, ly)
        mv = unresolved & (code >= 0)
        new_wall = unresolved & (code < 0)
        wall_slot = torch.where(new_wall, s_cur, wall_slot)
        wall = wall | new_wall
        if h == 0 and admit is not None:
            skipped = mv & (admit == 0)
            mv = mv & ~skipped
        idx = torch.where(mv, code, cur_tet.clamp(min=0))
        cur_rows = torch.where(mv[:, None], tab[idx], cur_rows)
        cur_tet = torch.where(mv, code, cur_tet)
        bw = _bary(cur_rows, px, py, pz)
        s_cur, wmin_h = _argmin4(*bw)
        unresolved = mv & (wmin_h < 0.0)
    unresolved = unresolved | skipped

    # inline single bounce (RTreflection bounce 1, RTQuery.cu:92-186) on
    # the last hop's barycentric weights, or absorb through the mask
    if n_hops and bounce_on:
        refl = wall
        esc = torch.zeros_like(wall)
        if esc_on:
            code_w = _codes(cur_rows, wall_slot, ly)
            escm = cur_rows[:, ly.esc].to(torch.int64)
            esc = wall & (code_w < 0) & (((escm >> wall_slot) & 1) > 0)
            refl = wall & ~esc
        rf = refl.to(T)
        gx, gy, gz = _grad(cur_rows, wall_slot)
        wv = _pick4(bw, wall_slot)
        gg = gx * gx + gy * gy + gz * gz
        # rf-masked reciprocal: a bare 1/gg would poison dead lanes with NaN
        inv_g2 = rf / (gg + (1.0 - rf))
        f = 2.0 * wv * inv_g2
        px = px - f * gx
        py = py - f * gy
        pz = pz - f * gz
        fu = 2.0 * (vx * gx + vy * gy + vz * gz) * inv_g2
        vx = vx - fu * gx
        vy = vy - fu * gy
        vz = vz - fu * gz
        wa2, wb2, wc2, wd2 = _bary(cur_rows, px, py, pz)
        wmin2 = torch.minimum(torch.minimum(wa2, wb2), torch.minimum(wc2, wd2))
        wall = refl & ~(refl & (wmin2 >= 0.0))
        tet1 = torch.where(esc, -(cur_tet + 1), cur_tet)
        actf = torch.where(esc, torch.zeros_like(actf), actf)
    else:
        tet1 = cur_tet

    pad = torch.zeros((rows.shape[0], ly.width - ROW - ly.tab_w), dtype=T, device=dev)
    head = torch.stack([px, py, pz, vx, vy, vz, tet1.to(T), actf], dim=1)
    return torch.cat([head, cur_rows, pad], dim=1), unresolved | wall


def stream_plain(tab, m, xi, pending, *, dt, sigma, use_adv, use_brown,
                 bounce_on, esc_on, n_hops, admit=None, crossers=None, ly=LAYOUT_TET,
                 rk4=False, stage_walks=None):
    """Plain version of ``stream_kernel``: updates ``m`` [n, ly.width] in
    place and writes ``pending`` [n] uint8; ``tab`` is :func:`row_table`
    of ``ly``.  ``dt``/``sigma`` are already rounded to m's dtype
    (:func:`scalars`); ``xi`` [n, 3] is read iff use_brown.

    The two stages of the compacted hop gather: with ``crossers`` [n]
    uint8 the call only writes each lane's hop-0 crossing flag (m and
    pending are left alone); with ``admit`` [n] uint8 (from
    :func:`hop_admit_plain`) a crosser whose flag is 0 skips its hop.

    ``rk4``: the RK4 integrator (``stream_kernel<..., kRK4>``; the whole
    pass only), each stage velocity from :func:`stage_velocity` on the
    lane's cached row and tet at the start of the cycle.
    ``stage_walks`` (int64 [3, 3]): adds, per stage, what
    :func:`stage_velocity` counts in ``walks``."""
    T, dev = m.dtype, m.device
    dt = torch.tensor(dt, dtype=T, device=dev)
    sigma = torch.tensor(sigma, dtype=T, device=dev)
    tet, alive, alf, actf = _lane_start(m, use_adv)
    rows = m[:, ROW : ROW + ly.tab_w]
    stage = None
    if rk4:
        if admit is not None or crossers is not None:
            raise ValueError("the RK4 stream has the whole pass only")
        live = alive & (tet >= 0)

        def stage(j, q):
            return stage_velocity(tab, rows, tet, live, q, ly,
                                  None if stage_walks is None else stage_walks[j])
    pos0 = (m[:, P0], m[:, P0 + 1], m[:, P0 + 2])
    (dx, dy, dz), vel = _sub_step(rows, pos0, (m[:, V0], m[:, V0 + 1], m[:, V0 + 2]), alf,
                                  alive, xi, dt=dt, sigma=sigma, use_adv=use_adv,
                                  use_brown=use_brown, ly=ly, stage=stage)
    pos = (pos0[0] + dx, pos0[1] + dy, pos0[2] + dz)
    bw = _bary(rows, *pos)
    s_cur, wmin = _argmin4(*bw)
    unresolved = (wmin < 0.0) & (tet >= 0)
    if crossers is not None:
        crossers.copy_(unresolved & (_codes(rows, s_cur, ly) >= 0))
        return
    out, pend = _resolve(tab, rows, bw, s_cur, unresolved, tet, admit, pos, vel, actf,
                         n_hops=n_hops, bounce_on=bounce_on, esc_on=esc_on, ly=ly)
    m.copy_(out)
    pending.copy_(pend)


# ---------------------------------------------------------------------------
# K3: admission of the block-compacted hop gather (plain version of
# csrc/hop_admit.cu)
# ---------------------------------------------------------------------------

HOP_GROUP = 4          # lanes per group (hop_compact=4)
_PACK_LANES = 8192     # the JAX packed path pads the lane count to this
_CAP_STEP = 1024       # capacity granularity in groups (fused_pallas.CB_SRC)


def hop_capacity(n: int, frac: float) -> int:
    """Admitted-group capacity ``capb`` of ``_compact_hop_rows``
    (``fused_pallas.py:612``) for ``n`` lanes at ``hop_compact_frac``
    ``frac``: nb4 is a quarter of n rounded up to 8192 lanes, as the JAX
    packed path pads it, so the port admits the same groups."""
    nb4 = -(-int(n) // _PACK_LANES) * _PACK_LANES // HOP_GROUP
    return min(max(-(-int(nb4 * frac) // _CAP_STEP) * _CAP_STEP, _CAP_STEP), nb4)


def hop_admit_plain(crossers, admit, *, capb):
    """Plain version of ``hop_admit_kernel``: group g (lanes 4g..4g+3) is
    pending when it holds a crosser (``crossers`` [n] uint8) and admitted
    when fewer than ``capb`` pending groups precede it; ``admit`` [n]
    uint8 marks each crosser of an admitted group with fewer than 2
    crossers before it in the group."""
    n = crossers.shape[0]
    ng = -(-n // HOP_GROUP)
    c = torch.zeros(ng * HOP_GROUP, dtype=torch.int64, device=crossers.device)
    c[:n] = (crossers > 0).to(torch.int64)
    c4 = c.view(ng, HOP_GROUP)
    gp = c4.sum(dim=1) > 0
    rank = torch.cumsum(gp.to(torch.int64), 0) - gp.to(torch.int64)
    before = torch.cumsum(c4, dim=1) - c4
    ok = (c4 > 0) & (gp & (rank < capb))[:, None] & (before < 2)
    admit.copy_(ok.reshape(-1)[:n])


# ---------------------------------------------------------------------------
# K4: one trip of a macro cycle (plain version of csrc/macro.cu)
# ---------------------------------------------------------------------------


def macro_stream_plain(tab, m, xi, phase, pending, *, k, dt, sigma, use_adv, use_brown,
                       bounce_on, esc_on, admit=None, crossers=None):
    """Plain version of ``macro_stream_kernel``: lanes whose ``phase`` [n]
    uint8 is below ``k`` advance sub-steps phase..k-1 (noise ``xi`` [k, n,
    3], read iff use_brown) until their first face crossing or wall hit,
    resolve it with one inline hop as :func:`stream_plain` does, and
    advance their phase (j+1 when stopped at sub-step j, k when finished);
    updates ``m`` and ``phase`` in place and writes ``pending``.  Lanes at
    phase k are left alone and not pending.  ``crossers`` / ``admit``: the
    two stages of a compacted trip, as in :func:`stream_plain`."""
    T, dev = m.dtype, m.device
    dt = torch.tensor(dt, dtype=T, device=dev)
    sigma = torch.tensor(sigma, dtype=T, device=dev)
    tet, alive, alf, actf = _lane_start(m, use_adv)
    rows = m[:, ROW : ROW + LAYOUT_TET.row_w]
    ph = phase.to(torch.int64)
    run = ph < k
    pos = (m[:, P0], m[:, P0 + 1], m[:, P0 + 2])
    vel = (m[:, V0], m[:, V0 + 1], m[:, V0 + 2])
    bw = _bary(rows, *pos)
    s_cur = torch.zeros_like(tet)
    need = torch.zeros_like(run)
    for j in range(k):
        ex = run & ~need & (ph == j)
        d, v = _sub_step(rows, pos, vel, alf, alive, xi[j] if use_brown else None, dt=dt,
                         sigma=sigma, use_adv=use_adv, use_brown=use_brown)
        pos = tuple(torch.where(ex, p + dp, p) for p, dp in zip(pos, d))
        vel = tuple(torch.where(ex, a, b) for a, b in zip(v, vel))
        bw_j = _bary(rows, *pos)
        s_j, wmin = _argmin4(*bw_j)
        bw = tuple(torch.where(ex, a, b) for a, b in zip(bw_j, bw))
        s_cur = torch.where(ex, s_j, s_cur)
        stop = ex & (wmin < 0.0) & (tet >= 0)
        need = need | stop
        ph = torch.where(ex & ~stop, j + 1, ph)
    if crossers is not None:
        crossers.copy_(need & (_codes(rows, s_cur) >= 0))
        return
    out, pend = _resolve(tab, rows, bw, s_cur, need, tet, admit, pos, vel, actf,
                         n_hops=1, bounce_on=bounce_on, esc_on=esc_on)
    m.copy_(torch.where(run[:, None], out, m))
    pending.copy_(pend & run)
    phase.copy_(torch.where(need, ph + 1, ph))


# ---------------------------------------------------------------------------
# K7: the rare stage (plain version of csrc/rare.cu)
# ---------------------------------------------------------------------------


def _walk(tab, rows, tet0, px, py, pz, act, max_hops, ly=LAYOUT_TET, chain=None):
    """``_walk_mega``: baryTetSearch from the cached rows toward (px,py,pz).
    Runs max(2, max_hops) hops at most (the JAX package unrolls two hops
    before its bounded loop).  Returns (rows of the last non-negative tet,
    code = hosting tet or -(lastTet+1) or the last tet when out of hops,
    slot = last crossed face).  ``chain`` (int64, one per lane): adds each
    lane's table row loads (one per hop into a tet)."""
    tet = tet0.clone()
    done = (tet0 < 0) | ~act
    slot = torch.zeros_like(tet0)
    for _ in range(max(2, max_hops)):
        if bool(done.all()):
            break
        s, wmin = _argmin4(*_bary(rows, px, py, pz))
        inside = wmin >= 0.0
        stepping = ~done & ~inside
        code = _codes(rows, s, ly)
        out = stepping & (code < 0)
        tet = torch.where(stepping, torch.where(out, -(tet + 1), code), tet)
        slot = torch.where(stepping, s, slot)
        moved = stepping & (code >= 0)
        if chain is not None:
            chain += moved
        rows = torch.where(moved[:, None], tab[torch.where(moved, code, 0)], rows)
        done = done | inside | out
    return rows, tet, slot


def _remote_sentinel(code, remote):
    """The migration sentinel -(per + g + 1) of a lane paused at the remote
    code ``code`` = -(R0 + 1 + g)."""
    R0, per = remote
    return -(per + (-code - R0 - 1) + 1)


def _reflect(tab, rows, vel, px, py, pz, code, slot, bd_escape, max_bounces,
             ly=LAYOUT_TET, chain=None, remote=None, act=None):
    """``_reflect_mega``: mirror across the exit face of the cached exit-tet
    row, re-walk (default MAX_HOPS, not cfg.max_hops), repeat up to
    ``max_bounces``; absorbing faces (``bd_escape``) deactivate the lane
    with tet = -(tet+1).  A lane out of bounces keeps its non-negative
    exit tet.  ``chain``: adds the re-walks' row loads, as :func:`_walk`
    (the mirror reads the cached row).  ``act``: the lanes that reflect
    (default every lane with a negative code).  ``remote=(R0, per)``: a
    partitioned shard's table (``parallel/partition.py``), where a code
    below -R0 is a tet of another shard; a re-walk that meets one pauses
    the lane at the mirrored point reached so far, its tet the sentinel
    -(per + g + 1) (``_reflect_mega``'s remote branch, tested before the
    escape test)."""
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    hit = code < 0 if act is None else act & (code < 0)
    tet = torch.where(hit, -(code + 1), code)
    settled = ~hit
    s = slot
    nbd = bd_escape.shape[0]
    for _ in range(max_bounces):
        if bool(settled.all()):
            break
        refl = ~settled
        code_nbr = _codes(rows, s, ly)
        if remote is not None:
            remw = refl & (code_nbr < -remote[0])
            tet = torch.where(remw, _remote_sentinel(code_nbr, remote), tet)
            settled = settled | remw
            refl = refl & ~remw
        if nbd:
            bd = (-code_nbr - 1).clamp(0, nbd - 1)
            esc = refl & (code_nbr < 0) & bd_escape[bd]
        else:
            esc = torch.zeros_like(refl)
        tet = torch.where(esc, -(tet + 1), tet)
        settled = settled | esc
        refl = refl & ~esc
        gx, gy, gz = _grad(rows, s)
        wv = _pick4(_bary(rows, px, py, pz), s)
        inv_g2 = 1.0 / (gx * gx + gy * gy + gz * gz)
        f = 2.0 * wv * inv_g2
        px = torch.where(refl, px - f * gx, px)
        py = torch.where(refl, py - f * gy, py)
        pz = torch.where(refl, pz - f * gz, pz)
        ug = vx * gx + vy * gy + vz * gz
        fu = 2.0 * ug * inv_g2
        vx = torch.where(refl, vx - fu * gx, vx)
        vy = torch.where(refl, vy - fu * gy, vy)
        vz = torch.where(refl, vz - fu * gz, vz)
        rows_w, wtet, wslot = _walk(tab, rows, tet.clamp(min=0), px, py, pz,
                                    refl, MAX_HOPS, ly, chain)
        in_dom = wtet >= 0
        newly = refl & in_dom
        tet = torch.where(newly, wtet, torch.where(refl, -(wtet + 1), tet))
        s = torch.where(refl & ~in_dom, wslot, s)
        rows = torch.where(refl[:, None], rows_w, rows)
        settled = settled | newly
    return rows, torch.stack([vx, vy, vz], dim=1), px, py, pz, tet


def _rare_lanes(tab, m, idx, bd_escape, max_hops, max_bounces, reflect_wall, ly, chain,
                remote=None):
    """The new mega rows of lanes ``idx`` (walk, then reflect).  With
    ``remote=(R0, per)`` a walk that exits through a remote code pauses the
    lane instead of reflecting it (``_make_run_lanes_remote``)."""
    mc = m[idx]
    rw = ly.tab_w
    qx, qy, qz = mc[:, P0], mc[:, P0 + 1], mc[:, P0 + 2]
    act = torch.ones(idx.shape[0], dtype=torch.bool, device=m.device)
    rows, code, slot = _walk(tab, mc[:, ROW : ROW + rw], mc[:, TET].to(torch.int64),
                             qx, qy, qz, act, max_hops, ly, chain)
    wall = rem = None
    if remote is not None:
        exit_code = _codes(rows, slot, ly)
        rem = (code < 0) & (exit_code < -remote[0])
        wall = (code < 0) & ~rem
    vel = mc[:, V0 : V0 + 3]
    if reflect_wall:
        rows, vel, qx, qy, qz, code = _reflect(
            tab, rows, vel, qx, qy, qz, code, slot, bd_escape, max_bounces, ly, chain,
            remote=remote, act=wall)
    if rem is not None:
        code = torch.where(rem, _remote_sentinel(exit_code, remote), code)
    return torch.cat([torch.stack([qx, qy, qz], dim=1), vel,
                      code.to(m.dtype)[:, None], mc[:, ACT : ACT + 1], rows,
                      mc[:, ROW + rw :]], dim=1)


def rare_plain(tab, m, pending, bd_escape, *, max_hops, max_bounces,
               reflect_wall, ly=LAYOUT_TET, chain=None, remote=None):
    """Plain version of ``rare_kernel``: resolve every lane whose
    ``pending`` flag is set (walk, then reflect), updating ``m`` in place:
    pos, vel, tet and the row cache; the active column is left as is (a
    lane that left the domain is killed by the next cycle's advect).
    ``tab`` is :func:`row_table` of ``ly``.  ``chain`` ([n_pending] int64
    zeros): receives each pending lane's chain (:func:`rare_chain`).

    ``remote=(R0, per)``: plain version of ``rare_kernel<T, L, kRemote>``,
    the rare stage of a partitioned shard (``partition._make_run_lanes_remote``
    with ``_reflect_mega(remote=)``): ``tab`` is the shard's slab of
    ``per`` rows, whose codes below -R0 are tets g of other shards; a walk
    that exits through one, or a re-walk after a bounce that meets one,
    pauses the lane with tet -(per + g + 1)."""
    idx = pending.nonzero()[:, 0]
    if idx.numel() == 0:
        return
    m[idx] = _rare_lanes(tab, m, idx, bd_escape, max_hops, max_bounces, reflect_wall, ly,
                         chain, remote)


def rare_chain(tab, m, pending, bd_escape, *, max_hops, max_bounces, reflect_wall,
               ly=LAYOUT_TET, remote=None):
    """The dependent chain of each pending lane of ``rare_kernel``, in lane
    order: [n_pending] int64 table row loads, one per hop of the walk and of
    each re-walk after a bounce, beyond the flag and the lane's own mega row
    (``traffic.latency_bound`` adds those two).  ``m`` is not touched; the
    arguments are :func:`rare_plain`'s."""
    idx = pending.nonzero()[:, 0]
    chain = torch.zeros(idx.shape[0], dtype=torch.int64, device=m.device)
    if idx.numel():
        _rare_lanes(tab, m, idx, bd_escape, max_hops, max_bounces, reflect_wall, ly, chain,
                    remote)
    return chain


# ---------------------------------------------------------------------------
# one cycle, and one macro cycle
# ---------------------------------------------------------------------------


def cycle_noise(cfg, seed, step, n, dtype, device, noise=None, k=None, lane_offset=0):
    """(xi, noise_key) of a cycle, or with ``k`` of a k-sub-step macro
    cycle: ``noise`` ([n, 3], or [k, n, 3]) when given; under
    ``brownian_rng`` "rbg"/"rbg_kernel" the Philox key of ``step`` and
    ``lane_offset`` (the kernels draw the stream themselves, sub-step j of
    a macro cycle with step + j); else the threefry draws of the steps,
    which take no lane offset (as in the JAX package)."""
    if not cfg.use_brownian:
        return None, None
    if noise is not None:
        return noise, None
    if cfg.brownian_rng in RBG_MODES:
        return None, philox_key(seed, step, lane_offset)
    if k is None:
        return _brownian_noise(seed, step, n, dtype, device, cfg.brownian_rng), None
    return torch.stack([_brownian_noise(seed, step + j, n, dtype, device, cfg.brownian_rng)
                        for j in range(k)]), None


def stream_kwargs(cfg, dt, dtype):
    """The sub-step arguments every stream wrapper takes (dt, sigma rounded
    to ``dtype``, use_adv, use_brown)."""
    dt_t, sigma = scalars(cfg, dt, dtype)
    return dict(dt=dt_t, sigma=sigma, use_adv=cfg.use_advection, use_brown=cfg.use_brownian)


def compact_scratch(n, device) -> dict:
    """The buffers a compacted stream stage needs besides ``pending``, for a
    caller that runs many cycles to allocate once (``run_cycles`` does):
    ``phase``, ``crossers`` and ``admit`` [n] uint8 and the zeroed ``words``
    of ``fused_cuda.hop_admit_scratch``."""
    from . import fused_cuda

    flags = {name: torch.empty(n, dtype=torch.uint8, device=device)
             for name in ("phase", "crossers", "admit")}
    return dict(flags, words=fused_cuda.hop_admit_scratch(n, device))


def mega_cycle(mesh: TetMesh, m, seed, step, cfg, dt, noise=None,
               pending=None, scratch=None, lane_offset=0) -> torch.Tensor:
    """One sub-step over the mega state, in place: stream kernel, then the
    rare kernel over the pending lanes.  The layout is that of
    ``cfg.velocity_interp`` (:func:`layout_for`), the table its
    :func:`row_table`.  ``noise`` [n, 3] replaces the
    noise draw (parity replays); under ``brownian_rng`` "rbg"/"rbg_kernel"
    a CUDA mega draws the Philox stream inside the stream kernel.
    ``pending`` is optional [n] uint8 scratch, ``scratch`` the optional
    buffers of :func:`compact_scratch` (used under ``hop_compact=4``).
    ``lane_offset``: the global index of lane 0 (a data-parallel shard's;
    it enters the Philox key, :func:`philox_key`).

    With ``hop_compact=4`` and one inline hop the stream runs as the
    compacted hop gather: the crossing flags, ``hop_admit`` at capacity
    :func:`hop_capacity`, then the stream kernel with the admission flags.
    The JAX package engages it on its TPU packed path only (n >=
    ``PACK_MIN_LANES``, a TPU speed threshold); the port applies it
    whenever it is set.  The state after the rare stage is the same either
    way: a crosser the compaction skips walks from its pre-hop tet.  Under
    ``LAYOUT_PK`` ``hop_compact`` is ignored, as in the JAX package
    (``_b_compute_c`` takes no layout).

    ``integrator="rk4"``: the stream kernel's RK4 instantiation (its stage
    walks inside the kernel, two launches a cycle as for Euler);
    ``hop_compact`` is ignored, as on JAX's jnp path, which runs RK4."""
    from . import fused_cuda

    ly = layout_for(cfg)
    tab = row_table(mesh, ly)
    n, dev = m.shape[0], m.device
    if pending is None:
        pending = torch.empty(n, dtype=torch.uint8, device=dev)
    xi, key = cycle_noise(cfg, seed, step, n, m.dtype, dev, noise, lane_offset=lane_offset)
    kw = stream_kwargs(cfg, dt, m.dtype)
    rk4 = cfg.integrator == "rk4"
    admit = None
    if (cfg.hop_compact == HOP_GROUP and cfg.inline_hops == 1 and ly is LAYOUT_TET
            and not rk4):
        sc = compact_scratch(n, dev) if scratch is None else scratch
        crossers, admit = sc["crossers"], sc["admit"]
        fused_cuda.stream_crossers(tab, m, xi, crossers, noise_key=key, **kw)
        fused_cuda.hop_admit(crossers, admit, capb=hop_capacity(n, cfg.hop_compact_frac),
                             scratch=sc["words"])
    fused_cuda.stream_cycle(
        tab, m, xi, pending, bounce_on=cfg.reflect_wall and cfg.inline_bounce,
        esc_on=cfg.escape_faces, n_hops=cfg.inline_hops, noise_key=key, admit=admit, ly=ly,
        rk4=rk4, **kw)
    fused_cuda.rare_resolve(
        tab, m, pending, mesh.bd_escape, max_hops=cfg.max_hops,
        max_bounces=cfg.max_bounces, reflect_wall=cfg.reflect_wall, ly=ly,
    )
    return m


def trip_fraction(cfg, trip: int) -> float:
    """``hop_compact_frac`` of macro trip ``trip`` >= 1: halved per trip
    and kept in [0.05, 1] (``fused_pallas.py:1755-1758``)."""
    return min(max(cfg.hop_compact_frac / 2 ** (trip - 1), 0.05), 1.0)


def mega_macro(mesh: TetMesh, m, seed, step, cfg, dt, noise=None,
               pending=None, scratch=None, lane_offset=0) -> torch.Tensor:
    """``k = cfg.macro_cycles`` sub-steps (steps step..step+k-1) as one
    macro cycle, in place: k trips, each the macro stream kernel and the
    rare kernel over its pending lanes (``fused_pallas.macro_cycle_packed``).
    Trip 0 hops every crosser; trips t >= 1 always run the compacted hop
    gather at :func:`trip_fraction`, whatever ``cfg.hop_compact`` says, as
    JAX does.  One inline hop per trip, whatever ``inline_hops`` says.
    ``noise`` [k, n, 3] replaces the noise draw; ``pending`` and
    ``scratch`` (:func:`compact_scratch`) are optional buffers.  Equal to
    k :func:`mega_cycle` calls; the TetVelocity bary engine only.
    ``lane_offset`` as in :func:`mega_cycle`."""
    from . import fused_cuda

    k = cfg.macro_cycles
    n, dev = m.shape[0], m.device
    if pending is None:
        pending = torch.empty(n, dtype=torch.uint8, device=dev)
    xi, key = cycle_noise(cfg, seed, step, n, m.dtype, dev, noise, k=k, lane_offset=lane_offset)
    kw = dict(stream_kwargs(cfg, dt, m.dtype), k=k, noise_key=key)
    sc = compact_scratch(n, dev) if scratch is None else scratch
    phase, crossers, admit = sc["phase"].zero_(), sc["crossers"], sc["admit"]
    for trip in range(k):
        if trip:
            fused_cuda.macro_crossers(mesh.tet_row, m, xi, phase, crossers, **kw)
            fused_cuda.hop_admit(crossers, admit, capb=hop_capacity(n, trip_fraction(cfg, trip)),
                                 scratch=sc["words"])
        fused_cuda.macro_stream(
            mesh.tet_row, m, xi, phase, pending, bounce_on=cfg.reflect_wall and cfg.inline_bounce,
            esc_on=cfg.escape_faces, admit=admit if trip else None, **kw)
        fused_cuda.rare_resolve(
            mesh.tet_row, m, pending, mesh.bd_escape, max_hops=cfg.max_hops,
            max_bounces=cfg.max_bounces, reflect_wall=cfg.reflect_wall)
    return m
