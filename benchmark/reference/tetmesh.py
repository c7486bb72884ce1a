"""Plain reference of the polyMesh -> tet decomposition, for the coupled
cell: each cell split into tets (cell centre, a face's base point and an
edge of the face's fan around it), as OpenFOAM's
``polyMeshTetDecomposition::cellTetIndices`` feeds the particle tracker
(``src/initCuda.H:86-124`` of cudaParticlesFoam).

Plain NumPy.  It imports nothing of the program; the points, faces, owners
and neighbours come from the reference's own blockMesh
(:mod:`reference.flow.blockmesh`), the cell centres from its own
:func:`reference.flow.polymesh.cell_centres_volumes`.

The base point of a face is the vertex whose fan maximises the smallest
tet quality over the face's cells (``findSharedBasePoint``).  On the
hexes of a blockMesh every candidate of a face ties to within the last
bits, so the choice hangs on rounding, and this file reproduces the
port's native builder expression for expression:

* each quality in double, with no fused multiply-add, the terms of every
  sum in the builder's order;
* ``rc**3`` through libm's ``pow`` (``math.pow``), one value at a time:
  numpy's ``power`` differs from it in the last bit on about 5% of
  inputs, which chose 184,235 of the TJunction's 769,200 bases otherwise;
* the first candidate that is strictly better wins; a smaller quality
  replaces the running minimum only when strictly smaller.

Departures from OpenFOAM: the quality is the builder's
``volume / (8 / (9 sqrt 3) rc^3 + 1e-300)`` with the circumradius capped
at 1e30, and a triangle keeps vertex 0 as its base.
"""

from __future__ import annotations

import math

import numpy as np

from .flow.polymesh import cell_centres_volumes

REGULAR = 8.0 / (9.0 * math.sqrt(3.0))   # the regular tet's volume over rc^3


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _libm_cube(x: np.ndarray) -> np.ndarray:
    return np.fromiter((math.pow(v, 3.0) for v in x.tolist()), dtype=np.float64,
                       count=x.shape[0])


def quality(apex, p0, p1, p2) -> np.ndarray:
    """The tet's quality, for arrays of points given as (x, y, z) columns."""
    e1, e2, e3 = _sub(p0, apex), _sub(p1, apex), _sub(p2, apex)
    c23 = _cross(e2, e3)
    det = _dot(e1, c23)
    vol = det / 6.0
    r1, r2, r3 = 0.5 * _dot(e1, e1), 0.5 * _dot(e2, e2), 0.5 * _dot(e3, e3)
    c31, c12 = _cross(e3, e1), _cross(e1, e2)
    ok = np.abs(det) > 1e-300
    safe = np.where(ok, det, 1e-300)
    u = tuple((r1 * c23[i] + r2 * c31[i] + r3 * c12[i]) / safe for i in range(3))
    rc = np.sqrt(_dot(u, u))
    rc = np.where(ok, rc, 1e30)
    rc = np.where(rc > 1e30, 1e30, rc)
    return vol / (REGULAR * _libm_cube(rc) + 1e-300)


def _cols(arr, idx):
    sel = arr[idx]
    return sel[:, 0], sel[:, 1], sel[:, 2]


def base_points(pm, cell_ctrs) -> np.ndarray:
    """The base vertex of each face, as a local index into the face."""
    sizes = np.diff(pm.face_offsets)
    n_int = pm.n_internal_faces
    base = np.zeros(pm.n_faces, dtype=np.int64)
    for k in np.unique(sizes):
        if k <= 3:
            continue
        sel = np.nonzero(sizes == k)[0]
        verts = pm.face_verts[pm.face_offsets[sel][:, None] + np.arange(k)[None, :]]
        inner = sel < n_int
        own = _cols(cell_ctrs, pm.owner[sel])
        nei = _cols(cell_ctrs, np.where(inner, pm.neighbour[np.minimum(sel, n_int - 1)], 0))
        best_q = np.full(len(sel), -1e300)
        best_c = np.zeros(len(sel), dtype=np.int64)
        for c in range(k):
            b = _cols(pm.points, verts[:, c])
            q = np.full(len(sel), 1e300)
            for i in range(1, k - 1):
                pa = _cols(pm.points, verts[:, (c + i) % k])
                pb = _cols(pm.points, verts[:, (c + i + 1) % k])
                qo = quality(own, b, pa, pb)
                q = np.where(qo < q, qo, q)
                # the neighbour sees the face reversed: the fan edge swapped
                qn = quality(nei, b, pb, pa)
                q = np.where(inner & (qn < q), qn, q)
            better = q > best_q
            best_q = np.where(better, q, best_q)
            best_c = np.where(better, c, best_c)
        base[sel] = best_c
    return base


def decompose(pm):
    """(points [n_points + n_cells, 3], tets [n_tets, 4], tet_cell [n_tets]):
    the mesh's points followed by its cell centres, and per tet the cell
    centre, the face's base point and a fan edge, the owner's tets winding
    with the face and the neighbour's against it.  Tets are grouped by face
    size, the owners' before the neighbours', then ordered by cell (stably),
    so that a cell's tets are contiguous."""
    cell_ctrs, _ = cell_centres_volumes(pm)
    n_pts = len(pm.points)
    sizes = np.diff(pm.face_offsets)
    n_int = pm.n_internal_faces
    base = base_points(pm, cell_ctrs)
    tets, tet_cell = [], []
    for k in np.unique(sizes):
        sel = np.nonzero(sizes == k)[0]
        verts = pm.face_verts[pm.face_offsets[sel][:, None] + np.arange(k)[None, :]]
        verts = np.take_along_axis(verts, (base[sel][:, None] + np.arange(k)[None, :]) % k,
                                   axis=1)
        fan_a, fan_b = verts[:, 1:k - 1], verts[:, 2:k]
        lead = np.broadcast_to(verts[:, :1], fan_a.shape)
        own = pm.owner[sel]
        apex = np.broadcast_to((n_pts + own)[:, None], fan_a.shape)
        tets.append(np.stack([apex, lead, fan_a, fan_b], axis=-1).reshape(-1, 4))
        tet_cell.append(np.repeat(own, k - 2))
        inner = sel < n_int
        nei = pm.neighbour[sel[inner]]
        apex = np.broadcast_to((n_pts + nei)[:, None], fan_a[inner].shape)
        tets.append(np.stack([apex, lead[inner], fan_b[inner], fan_a[inner]],
                             axis=-1).reshape(-1, 4))
        tet_cell.append(np.repeat(nei, k - 2))
    tets = np.concatenate(tets)
    tet_cell = np.concatenate(tet_cell)
    order = np.argsort(tet_cell, kind="stable")
    points = np.concatenate([np.asarray(pm.points, dtype=np.float64), cell_ctrs], axis=0)
    return points, tets[order].astype(np.int64), tet_cell[order].astype(np.int64)
