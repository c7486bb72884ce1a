"""Plain reference of a particle-tracking cycle: Euler advection through a
per-tet velocity, a Brownian kick, the barycentric tet walk and specular
wall reflection, for the benchmark's particle cells.

Plain PyTorch and NumPy.  It imports nothing of the program and takes
nothing it made: the tet tables are built here from the points, tets and
velocities the benchmark generates, and the noise of each sub-step is drawn
here from the seed, as the configuration's noise stream states it.

It is a frozen copy of the port's plain path (the stream and rare stages
of one cycle over the row-cached state, TetVelocity, barycentric locator,
Euler integrator, no absorbing patch), kept expression for expression so
that the card's kernels, which build with no multiply-add contraction,
agree with it bit for bit.  A later change to the program does not change
it.
"""

from __future__ import annotations

import numpy as np
import torch

# mega-row columns: pos 0:3 | vel 3:6 | tet 6 | active 7 | table row 8:28 | pad
P0, V0, TET, ACT, ROW = 0, 3, 6, 7, 8
WIDTH, TAB_W, VEL, NBR, ESC = 32, 20, 12, 15, 19
MAX_HOPS = 50
FACE_SLOTS = np.array([[1, 2, 3], [2, 0, 3], [0, 1, 3], [0, 2, 1]], dtype=np.int64)


# ---------------------------------------------------------------------------
# the tet table, from points and tets
# ---------------------------------------------------------------------------


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-1)


def _inv3(m):
    """Batched 3x3 inverse via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    inv = np.stack([np.stack([A, B, C], axis=-1), np.stack([D, E, F], axis=-1),
                    np.stack([G, H, I], axis=-1)], axis=-2)
    return inv / det[..., None, None]


def _neighbours(tets):
    """[nt, 4] neighbour across the face opposite each vertex, or
    -(boundary face + 1), boundary faces numbered in the order of their
    sorted vertex triples."""
    nt = tets.shape[0]
    tri = np.sort(tets[:, FACE_SLOTS].reshape(-1, 3), axis=1)
    key = (tri[:, 0] << 42) | (tri[:, 1] << 21) | tri[:, 2]
    _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    owner = np.repeat(np.arange(nt), 4)
    nbr = np.empty(4 * nt, dtype=np.int64)
    shared = counts[inverse[order]] == 2
    first = order[shared][0::2]
    second = order[shared][1::2]
    nbr[first] = owner[second]
    nbr[second] = owner[first]
    bd_faces = np.nonzero(counts == 1)[0]
    bd_code = np.zeros(len(counts), dtype=np.int64)
    bd_code[bd_faces] = -(np.arange(len(bd_faces)) + 1)
    lone = counts[inverse] == 1
    nbr[lone] = bd_code[inverse[lone]]
    return nbr.reshape(nt, 4), len(bd_faces)


def build_table(points, tets, tet_vel, dtype=torch.float32, device="cpu"):
    """(table [nt, 20], bd_escape [n boundary faces] bool) on ``device``:
    per tet its vertex A, the inverse of [B-A, C-A, D-A], its velocity, the
    four neighbour codes as exact floats and the escape mask (0: every wall
    reflects).  Tets of negative volume get their first two vertices
    swapped first."""
    points = np.asarray(points, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64).copy()
    if len(points) >= (1 << 21):
        raise ValueError("the face key packs vertex ids below 2^21")
    a, b, c, d = (points[tets[:, i]] for i in range(4))
    neg = np.einsum("ij,ij->i", d - a, _cross(b - a, c - a)) < 0.0
    tets[neg, 0], tets[neg, 1] = tets[neg, 1].copy(), tets[neg, 0].copy()
    a, b, c, d = (points[tets[:, i]] for i in range(4))
    tinv = _inv3(np.stack([b - a, c - a, d - a], axis=-1))
    nbr, n_bd = _neighbours(tets)
    nt = len(tets)
    row = np.zeros((nt, TAB_W))
    row[:, 0:3] = a
    row[:, 3:12] = tinv.reshape(nt, 9)
    row[:, VEL:VEL + 3] = tet_vel
    row[:, NBR:NBR + 4] = nbr.astype(np.float64)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    tab = torch.from_numpy(row.astype(np_dtype)).to(device)
    return tab, torch.zeros(n_bd, dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# the noise stream of the configuration: one torch.Generator per sub-step
# ---------------------------------------------------------------------------


def stream_seed(seed: int, step: int, device) -> int:
    """Generator seed of sub-step ``step``: on the card ``seed`` in the high
    and ``step`` in the low 32 bits; the CPU's generator keeps 32 bits, so
    there a splitmix64 hash of the pair."""
    if torch.device(device).type != "cpu":
        return ((int(seed) << 32) + int(step)) % (1 << 63)
    m = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 0x632BE59BD9B4E019) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) >> 1


def noise(seed: int, step: int, n: int, dtype, device) -> torch.Tensor:
    """Standard normals [n, 3] of sub-step ``step``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, step, device))
    return torch.randn((n, 3), generator=g, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# one cycle
# ---------------------------------------------------------------------------


def _bary(rows, px, py, pz):
    rx = px - rows[:, 0]
    ry = py - rows[:, 1]
    rz = pz - rows[:, 2]
    wb = rows[:, 3] * rx + rows[:, 4] * ry + rows[:, 5] * rz
    wc = rows[:, 6] * rx + rows[:, 7] * ry + rows[:, 8] * rz
    wd = rows[:, 9] * rx + rows[:, 10] * ry + rows[:, 11] * rz
    wa = 1.0 - wb - wc - wd
    return wa, wb, wc, wd


def _bary_seeding(rows, px, py, pz):
    """The weights as the seeding walk sums them: wA = 1 - ((wB + wC) + wD)."""
    _, wb, wc, wd = _bary(rows, px, py, pz)
    return 1.0 - ((wb + wc) + wd), wb, wc, wd


def _argmin4(wa, wb, wc, wd):
    """First-minimum argmin (strict '<')."""
    best = wa
    slot = torch.zeros(wa.shape, dtype=torch.int64, device=wa.device)
    for i, w in ((1, wb), (2, wc), (3, wd)):
        upd = w < best
        best = torch.where(upd, w, best)
        slot = torch.where(upd, torch.full_like(slot, i), slot)
    return slot, best


def _pick(cols, slot):
    return cols.gather(1, slot[:, None])[:, 0]


def _codes(rows, slot):
    return _pick(rows[:, NBR:NBR + 4], slot).to(torch.int64)


def _grad(rows, slot):
    """Gradient of barycentric component ``slot``."""
    def comp(o):
        g0 = -(rows[:, 3 + o] + rows[:, 6 + o] + rows[:, 9 + o])
        return _pick(torch.stack([g0, rows[:, 3 + o], rows[:, 6 + o], rows[:, 9 + o]], dim=1),
                     slot)

    return comp(0), comp(1), comp(2)


def _stream(tab, m, xi, *, dt, sigma, n_hops, bounce_on, counts):
    """Advect, kick, move, then up to ``n_hops`` hops from the cached row
    and the single inline bounce; returns (new mega rows, pending)."""
    T, dev = m.dtype, m.device
    dt = torch.tensor(dt, dtype=T, device=dev)
    sigma = torch.tensor(sigma, dtype=T, device=dev)
    tet = m[:, TET].to(torch.int64)
    alive = (m[:, ACT] > 0.5) & (tet >= 0)
    alf = alive.to(T)
    rows = m[:, ROW:ROW + TAB_W]
    ux, uy, uz = rows[:, VEL], rows[:, VEL + 1], rows[:, VEL + 2]
    dx, dy, dz = alf * ux * dt, alf * uy * dt, alf * uz * dt
    vx, vy, vz = (torch.where(alive, u, v) for u, v in
                  zip((ux, uy, uz), (m[:, V0], m[:, V0 + 1], m[:, V0 + 2])))
    dx = dx + alf * sigma * xi[:, 0]
    dy = dy + alf * sigma * xi[:, 1]
    dz = dz + alf * sigma * xi[:, 2]
    px, py, pz = m[:, P0] + dx, m[:, P0 + 1] + dy, m[:, P0 + 2] + dz
    bw = _bary(rows, px, py, pz)
    s_cur, wmin = _argmin4(*bw)
    unresolved = (wmin < 0.0) & (tet >= 0)

    cur_rows, cur_tet = rows, tet
    wall = torch.zeros_like(unresolved)
    wall_slot = torch.zeros_like(s_cur)
    for _ in range(n_hops):
        code = _codes(cur_rows, s_cur)
        mv = unresolved & (code >= 0)
        new_wall = unresolved & (code < 0)
        wall_slot = torch.where(new_wall, s_cur, wall_slot)
        wall = wall | new_wall
        if counts is not None:
            counts["rows_loaded"] += int(mv.sum())
        idx = torch.where(mv, code, cur_tet.clamp(min=0))
        cur_rows = torch.where(mv[:, None], tab[idx], cur_rows)
        cur_tet = torch.where(mv, code, cur_tet)
        bw = _bary(cur_rows, px, py, pz)
        s_cur, wmin_h = _argmin4(*bw)
        unresolved = mv & (wmin_h < 0.0)
    if counts is not None:
        counts["rows_changed"] += int((cur_tet != tet).sum())

    if n_hops and bounce_on:
        rf = wall.to(T)
        gx, gy, gz = _grad(cur_rows, wall_slot)
        wv = _pick(torch.stack(bw, dim=1), wall_slot)
        gg = gx * gx + gy * gy + gz * gz
        inv_g2 = rf / (gg + (1.0 - rf))
        f = 2.0 * wv * inv_g2
        px = px - f * gx
        py = py - f * gy
        pz = pz - f * gz
        fu = 2.0 * (vx * gx + vy * gy + vz * gz) * inv_g2
        vx = vx - fu * gx
        vy = vy - fu * gy
        vz = vz - fu * gz
        w2 = _bary(cur_rows, px, py, pz)
        wmin2 = torch.minimum(torch.minimum(w2[0], w2[1]), torch.minimum(w2[2], w2[3]))
        wall = wall & ~(wall & (wmin2 >= 0.0))

    pad = torch.zeros((m.shape[0], WIDTH - ROW - TAB_W), dtype=T, device=dev)
    head = torch.stack([px, py, pz, vx, vy, vz, cur_tet.to(T), alf], dim=1)
    return torch.cat([head, cur_rows, pad], dim=1), unresolved | wall


def _walk(tab, rows, tet0, px, py, pz, act, max_hops, bary=_bary):
    """The bounded barycentric walk from the cached rows toward the point:
    (rows of the last tet in the domain, hosting tet or -(lastTet+1), or
    the last tet when out of hops, last crossed face)."""
    tet = tet0.clone()
    done = (tet0 < 0) | ~act
    slot = torch.zeros_like(tet0)
    for _ in range(max(2, max_hops)):
        if bool(done.all()):
            break
        s, wmin = _argmin4(*bary(rows, px, py, pz))
        inside = wmin >= 0.0
        stepping = ~done & ~inside
        code = _codes(rows, s)
        out = stepping & (code < 0)
        tet = torch.where(stepping, torch.where(out, -(tet + 1), code), tet)
        slot = torch.where(stepping, s, slot)
        moved = stepping & (code >= 0)
        rows = torch.where(moved[:, None], tab[torch.where(moved, code, 0)], rows)
        done = done | inside | out
    return rows, tet, slot


def _reflect(tab, rows, vel, px, py, pz, code, slot, bd_escape, max_bounces):
    """Mirror across the exit face, re-walk, up to ``max_bounces`` times."""
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    hit = code < 0
    tet = torch.where(hit, -(code + 1), code)
    settled = ~hit
    s = slot
    nbd = bd_escape.shape[0]
    for _ in range(max_bounces):
        if bool(settled.all()):
            break
        refl = ~settled
        code_nbr = _codes(rows, s)
        if nbd:
            bd = (-code_nbr - 1).clamp(0, nbd - 1)
            esc = refl & (code_nbr < 0) & bd_escape[bd]
        else:
            esc = torch.zeros_like(refl)
        tet = torch.where(esc, -(tet + 1), tet)
        settled = settled | esc
        refl = refl & ~esc
        gx, gy, gz = _grad(rows, s)
        wv = _pick(torch.stack(_bary(rows, px, py, pz), dim=1), s)
        inv_g2 = 1.0 / (gx * gx + gy * gy + gz * gz)
        f = 2.0 * wv * inv_g2
        px = torch.where(refl, px - f * gx, px)
        py = torch.where(refl, py - f * gy, py)
        pz = torch.where(refl, pz - f * gz, pz)
        fu = 2.0 * (vx * gx + vy * gy + vz * gz) * inv_g2
        vx = torch.where(refl, vx - fu * gx, vx)
        vy = torch.where(refl, vy - fu * gy, vy)
        vz = torch.where(refl, vz - fu * gz, vz)
        rows_w, wtet, wslot = _walk(tab, rows, tet.clamp(min=0), px, py, pz, refl, MAX_HOPS)
        in_dom = wtet >= 0
        newly = refl & in_dom
        tet = torch.where(newly, wtet, torch.where(refl, -(wtet + 1), tet))
        s = torch.where(refl & ~in_dom, wslot, s)
        rows = torch.where(refl[:, None], rows_w, rows)
        settled = settled | newly
    return rows, torch.stack([vx, vy, vz], dim=1), px, py, pz, tet


def _rare(tab, m, pending, bd_escape, *, max_hops, max_bounces):
    """Walk and reflect every pending lane, in place."""
    idx = pending.nonzero()[:, 0]
    if idx.numel() == 0:
        return
    mc = m[idx]
    qx, qy, qz = mc[:, P0], mc[:, P0 + 1], mc[:, P0 + 2]
    act = torch.ones(idx.shape[0], dtype=torch.bool, device=m.device)
    rows, code, slot = _walk(tab, mc[:, ROW:ROW + TAB_W], mc[:, TET].to(torch.int64),
                             qx, qy, qz, act, max_hops)
    rows, vel, qx, qy, qz, code = _reflect(tab, rows, mc[:, V0:V0 + 3], qx, qy, qz, code,
                                           slot, bd_escape, max_bounces)
    m[idx] = torch.cat([torch.stack([qx, qy, qz], dim=1), vel, code.to(m.dtype)[:, None],
                        mc[:, ACT:ACT + 1], rows, mc[:, ROW + TAB_W:]], dim=1)


def scalars(dt, diffusion_coeff, dtype):
    """(dt, sigma) rounded to the state dtype: dt first, then
    sigma = sqrt(T(2 D) * T(dt)) in T."""
    nt = np.float32 if dtype == torch.float32 else np.float64
    dt_t = np.asarray(dt, nt)
    return float(dt_t), float(np.sqrt(np.asarray(2.0 * diffusion_coeff, nt) * dt_t))


def pack(tab, pos, vel, tet, active):
    m = torch.zeros((pos.shape[0], WIDTH), dtype=pos.dtype, device=pos.device)
    m[:, P0:P0 + 3] = pos
    m[:, V0:V0 + 3] = vel
    m[:, TET] = tet.to(pos.dtype)
    m[:, ACT] = active.to(pos.dtype)
    m[:, ROW:ROW + TAB_W] = tab[tet.long().clamp(min=0)]
    return m


def run(tab, bd_escape, pos, vel, tet, active, *, seed, step, n_cycles, dt, diffusion_coeff,
        n_hops, bounce_on, max_hops=MAX_HOPS, max_bounces=10, counts=None, rounding=None):
    """``n_cycles`` sub-steps from steps ``step``..: (pos, vel, tet int32,
    active bool).  ``counts`` (a dict with "rows_loaded" and "rows_changed"):
    adds the table rows the inline hops load and the lanes whose row
    changed.  ``rounding``: a function applied to the mega rows after every
    stage (the lower-precision control rounds its float columns with it)."""
    dt_t, sigma = scalars(dt, diffusion_coeff, pos.dtype)
    m = pack(tab, pos, vel, tet, active)
    if rounding is not None:
        m = rounding(m)
    pending = None
    for i in range(n_cycles):
        xi = noise(seed, step + i, m.shape[0], m.dtype, m.device)
        m, pending = _stream(tab, m, xi, dt=dt_t, sigma=sigma, n_hops=n_hops,
                             bounce_on=bounce_on, counts=counts)
        if rounding is not None:
            m = rounding(m)
        _rare(tab, m, pending, bd_escape, max_hops=max_hops, max_bounces=max_bounces)
        if rounding is not None:
            m = rounding(m)
    return (m[:, P0:P0 + 3].clone(), m[:, V0:V0 + 3].clone(), m[:, TET].to(torch.int32),
            m[:, ACT] > 0.5)


def grid_start(points, tets, pos):
    """The tet each point's seeding walk starts from: a uniform grid over
    the points' bounds with about one cell a tet, each cell holding the last
    tet (by index) whose centroid falls in it, empty cells filled from their
    neighbours; a point's cell by truncation in the positions' dtype."""
    np_dtype = np.float32 if pos.dtype == torch.float32 else np.float64
    pts = np.asarray(points).astype(np_dtype).astype(np.float64)
    tets = np.asarray(tets, dtype=np.int64)
    cen = pts[tets].mean(axis=1)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-300)
    n_tets = tets.shape[0]
    g = np.maximum((extent / extent.prod() ** (1 / 3) * n_tets ** (1 / 3)).round().astype(int),
                   1)
    gx, gy, gz = int(g[0]), int(g[1]), int(g[2])
    inv_cell = np.array([gx, gy, gz], dtype=np.float64) / extent
    idx = np.clip(((cen - lo) * inv_cell).astype(np.int64), 0, [gx - 1, gy - 1, gz - 1])
    cell_tet = np.full(gx * gy * gz, -1, dtype=np.int64)
    cell_tet[(idx[:, 0] * gy + idx[:, 1]) * gz + idx[:, 2]] = np.arange(n_tets)
    grid = cell_tet.reshape(gx, gy, gz)
    for _ in range(max(gx, gy, gz)):
        if not (grid < 0).any():
            break
        for axis in (0, 1, 2):
            for shift in (1, -1):
                src = np.roll(grid, shift, axis=axis)
                grid = np.where((grid < 0) & (src >= 0), src, grid)
    grid = torch.as_tensor(np.where(grid < 0, 0, grid).reshape(-1), device=pos.device)
    rel = (pos - torch.as_tensor(lo, dtype=pos.dtype, device=pos.device)) * torch.as_tensor(
        inv_cell, dtype=pos.dtype, device=pos.device)
    top = torch.tensor([gx - 1, gy - 1, gz - 1], dtype=torch.int32, device=pos.device)
    ij = torch.minimum(torch.maximum(rel.to(torch.int32), torch.zeros_like(top)), top)
    return grid[((ij[:, 0] * gy + ij[:, 1]) * gz + ij[:, 2]).long()]


def locate(tab, points, tets, pos):
    """The tet holding each point (int32; -(lastTet+1) out of the domain):
    the seeding walk from :func:`grid_start`."""
    guess = grid_start(points, tets, pos)
    act = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    _, tet, _ = _walk(tab, tab[guess], guess, pos[:, 0], pos[:, 1], pos[:, 2], act, MAX_HOPS,
                      bary=_bary_seeding)
    return tet.to(torch.int32)


def _round_bf16(x, keep):
    r = x.to(torch.bfloat16).to(x.dtype)
    mask = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    mask[keep] = True
    return torch.where(mask, x, r)


def round_mega_bf16(m):
    """The control's rounding of the mega rows: every float column (position,
    velocity, the cached A, Tinv and velocity) to bfloat16 and back; the
    exact integer columns (tet, active, neighbour codes, escape mask) kept."""
    return _round_bf16(m, [TET, ACT] + list(range(ROW + NBR, ROW + TAB_W)))


def round_table_bf16(tab):
    """The control's table: A, Tinv and velocity in bfloat16, codes kept."""
    return _round_bf16(tab, list(range(NBR, TAB_W)))
