"""A frozen copy of the port's ``io/blockmesh.py``: the flow reference builds
its own mesh from the case's blockMeshDict.

blockMesh-equivalent structured hex mesher.

The reference's tutorial pipeline depends on OpenFOAM's ``blockMesh``
(``tutorials/.../Allrun:8``); this module regenerates those meshes natively
so cases run end-to-end without an OpenFOAM install.  Supports the feature
set the tutorial dicts use (``pitzDaily/system/blockMeshDict``,
``TJunction/system/blockMeshDict``) and beyond: ``scale``, ``$var``
macros, hex blocks, ``simpleGrading`` / ``edgeGrading`` with scalar or
multi-section ``(lenFrac cellFrac ratio)`` specs, curved edges (``arc``
by interpolation point or ``origin``, ``polyLine``, ``spline``/
``BSpline`` as Catmull-Rom through the given points) via edge-transfinite
interpolation, named boundary patches (including ``empty`` for 2-D
cases).  Blocks without curved edges take a pure-trilinear fast path that
is bit-identical to the pre-curved-edge mesher.

Output is a :class:`~cudaparticlesfoam_tpu_torch.io.polymesh.PolyMesh` with
OpenFOAM's canonical face ordering (upper-triangular internal faces first,
then patch faces in declaration order), so it can be written back as a
standard ``constant/polyMesh``.

A copy of ``cudaparticlesfoam_tpu/io/blockmesh.py`` (numpy only), pinned
to it by ``tests/test_torch_io.py`` (equal ``PolyMesh`` arrays).
"""

from __future__ import annotations

import numpy as np

from . import foamfile
from .polymesh import PolyMesh

# local hex numbering (blockMesh convention):
# v0(0,0,0) v1(1,0,0) v2(1,1,0) v3(0,1,0) v4(0,0,1) v5(1,0,1) v6(1,1,1) v7(0,1,1)
_CORNER_UVW = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.float64,
)

# edge order for edgeGrading (12 entries): x-edges 0-1,3-2,7-6,4-5;
# y-edges 0-3,1-2,5-6,4-7; z-edges 0-4,1-5,2-6,3-7.
# For each direction, the 4 edges sit at the (other-two-axis) corners in the
# order (0,0), (1,0), (1,1), (0,1).
_EDGE_CORNER_POS = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])

# the 6 local faces of a hex as corner quads (outward-oriented), in
# blockMesh side order: x-min, x-max, y-min, y-max, z-min, z-max
_HEX_SIDES = np.array(
    [
        [0, 4, 7, 3],  # x-min
        [1, 2, 6, 5],  # x-max
        [0, 1, 5, 4],  # y-min
        [3, 7, 6, 2],  # y-max
        [0, 3, 2, 1],  # z-min
        [4, 5, 6, 7],  # z-max
    ]
)


def _section_counts(cell_fracs: np.ndarray, n: int) -> np.ndarray:
    """Integer cells per section by largest remainder, summing to n."""
    raw = cell_fracs / cell_fracs.sum() * n
    base = np.floor(raw).astype(int)
    rem = n - base.sum()
    order = np.argsort(-(raw - base))
    base[order[:rem]] += 1
    if (base == 0).any() and n >= len(base):
        # avoid empty sections by stealing from the largest
        for i in np.nonzero(base == 0)[0]:
            j = int(np.argmax(base))
            base[j] -= 1
            base[i] += 1
    return base


def _geometric_points(n: int, ratio: float) -> np.ndarray:
    """n+1 points in [0,1]; expansion ratio = lastCell/firstCell."""
    if n <= 0:
        return np.array([0.0, 1.0])
    if abs(ratio - 1.0) < 1e-12 or n == 1:
        return np.linspace(0.0, 1.0, n + 1)
    c = ratio ** (1.0 / (n - 1))
    w = c ** np.arange(n)
    w = w / w.sum()
    return np.concatenate([[0.0], np.cumsum(w)])


def _grading_points(spec, n: int) -> np.ndarray:
    """Normalized point distribution in [0,1] for a grading spec:
    scalar ratio or list of (lenFrac, cellFrac, ratio) sections."""
    if isinstance(spec, (int, float)):
        return _geometric_points(n, float(spec))
    sections = np.asarray(spec, dtype=np.float64)
    if sections.ndim == 1:
        sections = sections[None, :]
    len_fracs = sections[:, 0] / sections[:, 0].sum()
    counts = _section_counts(sections[:, 1], n)
    pts = [np.array([0.0])]
    x0 = 0.0
    for lf, cnt, (_, _, ratio) in zip(len_fracs, counts, sections):
        if cnt == 0:
            x0 += lf
            continue
        local = _geometric_points(int(cnt), float(ratio))[1:]
        pts.append(x0 + lf * local)
        x0 += lf
    out = np.concatenate(pts)
    out[-1] = 1.0
    return out


# local corner pairs of the 12 hex edges, grouped by direction, in the
# _EDGE_CORNER_POS cross-axis corner order (0,0),(1,0),(1,1),(0,1)
_EDGE_LOCAL = {
    0: [(0, 1), (3, 2), (7, 6), (4, 5)],
    1: [(0, 3), (1, 2), (5, 6), (4, 7)],
    2: [(0, 4), (1, 5), (2, 6), (3, 7)],
}


def _arc_3pt(p0, p1, pm):
    """Circular arc through p0 -> pm -> p1; returns C(t) vectorized over a
    parameter grid t in [0,1] (t measured as angle fraction)."""
    A, B, C = np.asarray(p0), np.asarray(pm), np.asarray(p1)
    a = A - C
    b = B - C
    axb = np.cross(a, b)
    n2 = float(axb @ axb)
    if n2 < 1e-30:          # collinear: degenerate, straight line
        return lambda t: A + np.asarray(t)[..., None] * (C - A)
    centre = C + np.cross((a @ a) * b - (b @ b) * a, axb) / (2.0 * n2)
    r0 = A - centre
    rm = B - centre
    r1 = C - centre
    nhat = np.cross(r0, rm)
    nhat = nhat / (np.linalg.norm(nhat) + 1e-300)
    r2 = float(r0 @ r0)
    cosb = float(r0 @ r1) / r2
    sinb = float(np.cross(r0, r1) @ nhat) / r2
    beta = np.arctan2(sinb, cosb) % (2.0 * np.pi)

    def curve(t):
        th = np.asarray(t)[..., None] * beta
        # Rodrigues rotation of r0 about nhat
        ct, st = np.cos(th), np.sin(th)
        k = nhat
        rot = (
            r0 * ct
            + np.cross(k, r0) * st
            + k * (k @ r0) * (1.0 - ct)
        )
        return centre + rot

    return curve


def _arc_origin(p0, p1, origin):
    """``arc v0 v1 origin (x y z)`` form: minor arc about the centre."""
    A, C = np.asarray(p0), np.asarray(p1)
    centre = np.asarray(origin, float)
    r0 = A - centre
    r1 = C - centre
    nhat = np.cross(r0, r1)
    nn = np.linalg.norm(nhat)
    if nn < 1e-30:
        return lambda t: A + np.asarray(t)[..., None] * (C - A)
    nhat = nhat / nn
    r2 = float(r0 @ r0)
    cosb = float(r0 @ r1) / r2
    sinb = float(np.cross(r0, r1) @ nhat) / r2
    beta = np.arctan2(sinb, cosb) % (2.0 * np.pi)

    def curve(t):
        th = np.asarray(t)[..., None] * beta
        ct, st = np.cos(th), np.sin(th)
        k = nhat
        rot = r0 * ct + np.cross(k, r0) * st + k * (k @ r0) * (1.0 - ct)
        return centre + rot

    return curve


def _catmull_rom(p0, pts, p1):
    """Catmull-Rom through [p0, pts..., p1] with chord-length parameters
    (the spline/BSpline edge types; polyLine uses the linear variant)."""
    P = np.vstack([p0, pts, p1]) if len(pts) else np.vstack([p0, p1])
    seg = np.linalg.norm(np.diff(P, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    s = s / (s[-1] + 1e-300)
    # endpoint-clamped phantom points
    Pe = np.vstack([2 * P[0] - P[1], P, 2 * P[-1] - P[-2]])

    def curve(t):
        t = np.clip(np.asarray(t, float), 0.0, 1.0)
        idx = np.clip(np.searchsorted(s, t, side="right") - 1, 0, len(s) - 2)
        t0, t1 = s[idx], s[idx + 1]
        u = ((t - t0) / np.maximum(t1 - t0, 1e-300))[..., None]
        pA, pB, pC, pD = Pe[idx], Pe[idx + 1], Pe[idx + 2], Pe[idx + 3]
        return 0.5 * (
            (2.0 * pB)
            + (-pA + pC) * u
            + (2.0 * pA - 5.0 * pB + 4.0 * pC - pD) * u * u
            + (-pA + 3.0 * pB - 3.0 * pC + pD) * u * u * u
        )

    return curve


def _polyline(p0, pts, p1):
    P = np.vstack([p0, pts, p1]) if len(pts) else np.vstack([p0, p1])
    seg = np.linalg.norm(np.diff(P, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    s = s / (s[-1] + 1e-300)

    def curve(t):
        t = np.clip(np.asarray(t, float), 0.0, 1.0)
        idx = np.clip(np.searchsorted(s, t, side="right") - 1, 0, len(s) - 2)
        u = ((t - s[idx]) / np.maximum(s[idx + 1] - s[idx], 1e-300))[..., None]
        return P[idx] + u * (P[idx + 1] - P[idx])

    return curve


def _parse_edges(entries, vertices, scale):
    """edges list -> {(v0, v1): curve fn} (curve parameter runs v0 -> v1);
    vertex ids are the blockMeshDict vertex indices."""
    curves = {}
    i = 0
    while i < len(entries):
        etype = str(entries[i])
        v0 = int(entries[i + 1])
        v1 = int(entries[i + 2])
        i += 3
        if etype == "line":
            continue
        if etype == "arc":
            if isinstance(entries[i], str) and entries[i] == "origin":
                org = np.asarray(entries[i + 1], float) * scale
                i += 2
                curves[(v0, v1)] = _arc_origin(vertices[v0], vertices[v1], org)
            else:
                mid = np.asarray(entries[i], float) * scale
                i += 1
                curves[(v0, v1)] = _arc_3pt(vertices[v0], vertices[v1], mid)
        elif etype in ("polyLine",):
            pts = np.asarray(entries[i], float).reshape(-1, 3) * scale
            i += 1
            curves[(v0, v1)] = _polyline(vertices[v0], pts, vertices[v1])
        elif etype in ("spline", "BSpline", "polySpline"):
            pts = np.asarray(entries[i], float).reshape(-1, 3) * scale
            i += 1
            curves[(v0, v1)] = _catmull_rom(vertices[v0], pts, vertices[v1])
        else:
            raise ValueError(f"unsupported edge type {etype!r}")
    return curves


def _block_points(corners: np.ndarray, n: tuple, gradings,
                  edge_curves=None) -> np.ndarray:
    """Points of one hex block [nx+1, ny+1, nz+1, 3].

    ``gradings`` = per direction, list of 4 specs (edge order above).
    Straight edges: transfinite interpolation of the 8 corners with local
    parameters obtained by fixed-point blending of the 4 edge distributions
    per direction (matches blockMesh's curvilinear point placement for
    straight edges).
    """
    nx, ny, nz = n
    # per-direction, per-edge normalized distributions
    dist = [
        [_grading_points(gradings[d][e], n[d]) for e in range(4)] for d in range(3)
    ]
    # initial params: mean of the 4 edge distributions
    iu = np.mean(dist[0], axis=0)  # [nx+1]
    iv = np.mean(dist[1], axis=0)
    iw = np.mean(dist[2], axis=0)
    U = np.broadcast_to(iu[:, None, None], (nx + 1, ny + 1, nz + 1)).copy()
    V = np.broadcast_to(iv[None, :, None], (nx + 1, ny + 1, nz + 1)).copy()
    W = np.broadcast_to(iw[None, None, :], (nx + 1, ny + 1, nz + 1)).copy()

    def blend(edge_dists, axis_idx, A, B):
        # bilinear weights over cross-axes params A, B at the 4 edge corners
        w0 = (1 - A) * (1 - B)
        w1 = A * (1 - B)
        w2 = A * B
        w3 = (1 - A) * B
        e = edge_dists
        shape = [1, 1, 1]
        shape[axis_idx] = -1
        e0, e1, e2, e3 = (np.reshape(x, shape) for x in e)
        return w0 * e0 + w1 * e1 + w2 * e2 + w3 * e3

    for _ in range(8):
        U = blend(dist[0], 0, V, W)
        V = blend(dist[1], 1, U, W)
        W = blend(dist[2], 2, U, V)

    # trilinear corner interpolation
    cu = np.stack([(1 - U) * (1 - V) * (1 - W),
                   U * (1 - V) * (1 - W),
                   U * V * (1 - W),
                   (1 - U) * V * (1 - W),
                   (1 - U) * (1 - V) * W,
                   U * (1 - V) * W,
                   U * V * W,
                   (1 - U) * V * W], axis=-1)           # [...,8]
    tri = np.einsum("...c,cj->...j", cu, corners)
    if not edge_curves or not any(fn is not None for fn in edge_curves.values()):
        # straight-edge fast path: bit-identical to the pre-curved mesher
        return tri

    # edge-transfinite interpolation: P = sum over the 12 edge terms minus
    # 2x the corner trilinear (each edge term with straight edges reduces
    # to the trilinear, so straight edges contribute exactly their share)
    params = (U, V, W)
    P = -2.0 * tri
    for d in range(3):
        t = params[d]
        # cross-axis params: for x-edges (v,w), y-edges (u,w), z-edges (u,v)
        cross = {0: (V, W), 1: (U, W), 2: (U, V)}[d]
        for e, (a, b) in enumerate(_EDGE_LOCAL[d]):
            fn = edge_curves.get((d, e))
            if fn is None:
                Ce = corners[a] + t[..., None] * (corners[b] - corners[a])
            else:
                Ce = fn(t)
            pa, pb = _EDGE_CORNER_POS[e]
            wgt = (cross[0] if pa else (1 - cross[0])) * (
                cross[1] if pb else (1 - cross[1])
            )
            P = P + wgt[..., None] * Ce
    return P


def _parse_blocks(entries, scope):
    """blocks list -> [(vert_ids[8], (nx,ny,nz), gradings[3][4], zone)]."""
    out = []
    i = 0
    while i < len(entries):
        tok = entries[i]
        assert tok == "hex", f"only hex blocks supported, got {tok!r}"
        vert_ids = entries[i + 1]
        i += 2
        # optional cell-zone name
        zone = None
        if isinstance(entries[i], str) and not isinstance(entries[i], list):
            zone = entries[i]
            i += 1
        n = tuple(int(x) for x in entries[i])
        i += 1
        gtype = entries[i]
        i += 1
        specs = [foamfile.expand_macros(s, scope) for s in entries[i]]
        i += 1
        if gtype == "simpleGrading":
            assert len(specs) == 3
            gradings = [[specs[d]] * 4 for d in range(3)]
        elif gtype == "edgeGrading":
            assert len(specs) == 12
            gradings = [specs[0:4], specs[4:8], specs[8:12]]
        else:
            raise ValueError(f"unsupported grading {gtype!r}")
        out.append((np.asarray(vert_ids, dtype=int), n, gradings, zone))
    return out


def _parse_boundary(entries):
    """boundary list -> [(name, type, [quad vertex-id lists])]."""
    out = []
    i = 0
    while i < len(entries):
        name = entries[i]
        spec = entries[i + 1]
        assert isinstance(spec, dict), f"bad boundary entry {name}"
        out.append((name, spec.get("type", "patch"), spec.get("faces", [])))
        i += 2
    return out


def generate(dict_path_or_text: str) -> PolyMesh:
    """Generate a PolyMesh from a blockMeshDict file or its text."""
    import os

    if os.path.exists(dict_path_or_text):
        with open(dict_path_or_text) as fh:
            text = fh.read()
    else:
        text = dict_path_or_text
    d = foamfile.parse(text)
    scale = float(d.get("scale", d.get("convertToMeters", 1.0)))
    vertices = np.asarray(d["vertices"], dtype=np.float64) * scale
    edge_specs = _parse_edges(d.get("edges") or [], vertices, scale)
    blocks = _parse_blocks(d["blocks"], d)
    boundary = _parse_boundary(d.get("boundary", []))

    # --- generate per-block points + hexes, merging shared points ---
    tol = 1e-10 * max(np.abs(vertices).max(), 1.0)
    all_pts = []
    block_point_ids = []
    for vert_ids, n, gradings, _zone in blocks:
        corners = vertices[vert_ids]
        block_edges = {}
        if edge_specs:
            for dd in range(3):
                for e, (a, b) in enumerate(_EDGE_LOCAL[dd]):
                    ga, gb = int(vert_ids[a]), int(vert_ids[b])
                    fn = edge_specs.get((ga, gb))
                    if fn is None:
                        rev = edge_specs.get((gb, ga))
                        if rev is not None:
                            fn = (lambda f: lambda t: f(1.0 - np.asarray(t)))(rev)
                    if fn is not None:
                        block_edges[(dd, e)] = fn
        pts = _block_points(corners, n, gradings, block_edges).reshape(-1, 3)
        block_point_ids.append(None)
        all_pts.append(pts)

    cat = np.concatenate(all_pts)
    keys = np.round(cat / tol).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    # representative coordinates: first occurrence
    first = np.full(len(uniq), -1, dtype=np.int64)
    seen_order = np.argsort(inverse, kind="stable")
    first[inverse[seen_order[::-1]]] = seen_order[::-1]
    points = cat[first]

    # global ids per block
    offset = 0
    for bi, (vert_ids, n, _, _zone) in enumerate(blocks):
        cnt = (n[0] + 1) * (n[1] + 1) * (n[2] + 1)
        block_point_ids[bi] = inverse[offset : offset + cnt].reshape(
            n[0] + 1, n[1] + 1, n[2] + 1
        )
        offset += cnt

    # --- hex cells ---
    hexes = []
    cell_block = []
    for bi, (vert_ids, n, _, _zone) in enumerate(blocks):
        g = block_point_ids[bi]
        nx, ny, nz = n
        # cell ordering: x fastest, then y, then z (blockMesh convention)
        i, j, k = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        i, j, k = (
            i.transpose(2, 1, 0).ravel(),
            j.transpose(2, 1, 0).ravel(),
            k.transpose(2, 1, 0).ravel(),
        )
        hx = np.stack(
            [
                g[i, j, k], g[i + 1, j, k], g[i + 1, j + 1, k], g[i, j + 1, k],
                g[i, j, k + 1], g[i + 1, j, k + 1], g[i + 1, j + 1, k + 1],
                g[i, j + 1, k + 1],
            ],
            axis=-1,
        )
        hexes.append(hx)
        cell_block.append(np.full(len(hx), bi))
    # cellZones from named blocks (hex (...) zoneName (...) ...)
    cell_zones = {}
    c0 = 0
    for bi, (vert_ids, n, _, zone) in enumerate(blocks):
        cnt = n[0] * n[1] * n[2]
        if zone is not None:
            cell_zones.setdefault(zone, []).append(np.arange(c0, c0 + cnt))
        c0 += cnt
    cell_zones = {
        k: np.concatenate(v).astype(np.int64) for k, v in cell_zones.items()
    } or None
    hexes = np.concatenate(hexes)
    n_cells = len(hexes)

    # --- faces: all 6 per hex, dedup ---
    quads = hexes[:, _HEX_SIDES]                    # [nc, 6, 4] outward
    flat = quads.reshape(-1, 4)
    skey = np.sort(flat, axis=1)
    uniq_f, inv_f, counts_f = np.unique(
        skey, axis=0, return_inverse=True, return_counts=True
    )
    cell_of = np.repeat(np.arange(n_cells), 6)

    # owner = lower cell id, neighbour = higher (OpenFOAM convention)
    nf = len(uniq_f)
    owner = np.full(nf, np.iinfo(np.int64).max, dtype=np.int64)
    neighbour = np.full(nf, -1, dtype=np.int64)
    np.minimum.at(owner, inv_f, cell_of)
    np.maximum.at(neighbour, inv_f, cell_of)
    internal = counts_f == 2
    neighbour_int = np.where(internal, neighbour, -1)

    # face vertex lists oriented outward from the OWNER: pick the quad
    # incidence whose cell == owner
    face_quad = np.zeros((nf, 4), dtype=np.int64)
    owner_incidence = owner[inv_f] == cell_of
    face_quad[inv_f[owner_incidence]] = flat[owner_incidence]

    # --- patch assignment ---
    # patch quads are corner-vertex quads of some block side; map each
    # boundary face to (block, side) then to patch
    # build per (block, side) the set of boundary faces via structured slices
    face_patch = np.full(nf, -1, dtype=np.int64)
    # side corner-quads per block, as sorted vertex-id keys
    patch_of_quad = {}
    for pi, (name, ptype, quads_spec) in enumerate(boundary):
        for q in quads_spec:
            patch_of_quad[tuple(sorted(int(x) for x in q))] = pi

    side_key_batches = []  # (keys, patch_id) collected per block side
    for bi, (vert_ids, n, _, _zone) in enumerate(blocks):
        for side in range(6):
            q_key = tuple(sorted(int(vert_ids[c]) for c in _HEX_SIDES[side]))
            pi = patch_of_quad.get(q_key)
            if pi is None:
                continue
            g = block_point_ids[bi]
            nx, ny, nz = n
            axis = side // 2
            hi = side % 2
            # the structured boundary quads of this block side
            if axis == 0:
                ii = nx if hi else 0
                a = g[ii, :-1, :-1].ravel()
                b = g[ii, 1:, :-1].ravel()
                c = g[ii, 1:, 1:].ravel()
                dd = g[ii, :-1, 1:].ravel()
            elif axis == 1:
                jj = ny if hi else 0
                a = g[:-1, jj, :-1].ravel()
                b = g[1:, jj, :-1].ravel()
                c = g[1:, jj, 1:].ravel()
                dd = g[:-1, jj, 1:].ravel()
            else:
                kk = nz if hi else 0
                a = g[:-1, :-1, kk].ravel()
                b = g[1:, :-1, kk].ravel()
                c = g[1:, 1:, kk].ravel()
                dd = g[:-1, 1:, kk].ravel()
            side_keys = np.sort(np.stack([a, b, c, dd], axis=-1), axis=1)
            side_key_batches.append((side_keys, pi))

    if side_key_batches:
        all_side_keys = np.concatenate([k for k, _ in side_key_batches])
        all_side_pids = np.concatenate(
            [np.full(len(k), pi) for k, pi in side_key_batches]
        )
        comb = np.concatenate([uniq_f, all_side_keys])
        _, inv2 = np.unique(comb, axis=0, return_inverse=True)
        lut = np.full(int(inv2.max()) + 1, -1, dtype=np.int64)
        lut[inv2[:nf]] = np.arange(nf)
        loc = lut[inv2[nf:]]
        ok = loc >= 0
        face_patch[loc[ok]] = all_side_pids[ok]

    # unassigned boundary faces -> the default patch (blockMesh semantics:
    # name/type from an optional ``defaultPatch {name; type;}`` entry,
    # defaulting to defaultFaces/empty).  A patch of that name declared in
    # the boundary list with ``faces ()`` sets its TYPE and receives the
    # faces — the idiom the reference's TJunction uses to make its
    # unlisted faces walls (``TJunction/system/blockMeshDict:116-120``,
    # consumed as walls by 0/k's kqRWallFunction); emitting a separate
    # empty-typed patch here used to silently disable every wall function
    # on that case.
    unassigned = (~internal) & (face_patch < 0)
    patches_spec = [(name, ptype) for name, ptype, _ in boundary]
    if unassigned.any():
        dp = d.get("defaultPatch", {})
        dp_name = str(dp.get("name", "defaultFaces")) if isinstance(dp, dict) \
            else "defaultFaces"
        dp_type = str(dp.get("type", "empty")) if isinstance(dp, dict) \
            else "empty"
        declared = [i for i, (n, _) in enumerate(patches_spec) if n == dp_name]
        if declared:
            face_patch[unassigned] = declared[0]
        else:
            face_patch[unassigned] = len(patches_spec)
            patches_spec.append((dp_name, dp_type))

    # --- canonical OpenFOAM face ordering ---
    # internal: sort by (owner, neighbour); boundary: by (patch, owner)
    int_ids = np.nonzero(internal)[0]
    int_order = int_ids[np.lexsort((neighbour_int[int_ids], owner[int_ids]))]
    bd_ids = np.nonzero(~internal)[0]
    bd_order = bd_ids[np.lexsort((owner[bd_ids], face_patch[bd_ids]))]
    order = np.concatenate([int_order, bd_order])

    face_verts = face_quad[order].reshape(-1)
    face_offsets = np.arange(len(order) + 1, dtype=np.int64) * 4
    owner_out = owner[order]
    neighbour_out = neighbour_int[int_order]

    patches = []
    start = len(int_order)
    bd_patches = face_patch[bd_order]
    for pi, (name, ptype) in enumerate(patches_spec):
        cnt = int((bd_patches == pi).sum())
        patches.append((name, ptype, start, cnt))
        start += cnt

    return PolyMesh(
        points=points,
        face_verts=face_verts,
        face_offsets=face_offsets,
        owner=owner_out,
        neighbour=neighbour_out,
        patches=patches,
        cell_zones=cell_zones,
    )
