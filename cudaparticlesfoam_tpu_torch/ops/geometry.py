"""Tetrahedral geometry primitives (port of ``cudaparticlesfoam_tpu/ops/geometry.py``).

The semantics of the reference's device geometry library
(``third_party/RTXAdvect/cuda/DeviceTetMesh.cuh:82-211``) as torch ops on
tensors whose last dimension is 3 (points); they broadcast over leading
dimensions, so they apply per particle, per tet or per (particle, face).
The engines use :func:`bary_from_tinv`; the rest are the JAX package's
public helpers, term for term.
"""

from __future__ import annotations

import torch


def dot3(a, b):
    return torch.sum(a * b, dim=-1)


def cross3(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def det4(a, b, c, d):
    """Signed 6*volume of tet (a,b,c,d): dot(d-a, cross(b-a, c-a))
    (``det(A,B,C,D)`` at ``DeviceTetMesh.cuh:82-88``)."""
    return dot3(d - a, cross3(b - a, c - a))


def tet_bary_coords(p, a, b, c, d):
    """Barycentric weights (wA, wB, wC, wD) of point p in tet (a,b,c,d)
    (``DeviceTetMesh.cuh:108-156``): three determinant ratios plus wD = 1 -
    wA - wB - wC; weight i is negative iff p lies beyond the face opposite
    vertex i.  Trailing dimension 4."""
    den = det4(a, b, c, d)
    inv = 1.0 / den
    wa = det4(p, b, c, d) * inv
    wb = det4(a, p, c, d) * inv
    wc = det4(a, b, p, d) * inv
    wd = 1.0 - wa - wb - wc
    return torch.stack([wa, wb, wc, wd], dim=-1)


def tet_edge_matrix(a, b, c, d):
    """Edge matrix M with columns (b-a, c-a, d-a); bary = M^-1 (p-a)."""
    return torch.stack([b - a, c - a, d - a], dim=-1)


def invert3x3(m):
    """Closed-form (adjugate) inverse of 3x3 matrices, batched over leading
    dimensions."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / det
    rows = [torch.stack(r, dim=-1) for r in ((c00, c01, c02), (c10, c11, c12), (c20, c21, c22))]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def bary_from_tinv(p, a, tinv):
    """Barycentric weights [..., 4] (wA, wB, wC, wD) of points ``p`` [..., 3]
    from the per-tet origin ``a`` [..., 3] and inverse edge matrix ``tinv``
    [..., 3, 3] (``invert3x3(tet_edge_matrix(...))``): one 3x3 matvec a
    point, associated as the JAX package's ``bary_from_tinv`` sums it (left
    to right), in the vertex order of :func:`tet_bary_coords`."""
    rel = p - a
    wbcd = (tinv[..., :, 0] * rel[..., None, 0] + tinv[..., :, 1] * rel[..., None, 1]
            + tinv[..., :, 2] * rel[..., None, 2])
    wa = 1.0 - ((wbcd[..., 0] + wbcd[..., 1]) + wbcd[..., 2])
    return torch.cat([wa[..., None], wbcd], dim=-1)


def tri_bary_coords(p, a, b, c):
    """Barycentric (u, v, w) of p in triangle abc (``DeviceTetMesh.cuh:158-177``)."""
    v0, v1, v2 = b - a, c - a, p - a
    d00, d01 = dot3(v0, v0), dot3(v0, v1)
    d11 = dot3(v1, v1)
    d20, d21 = dot3(v2, v0), dot3(v2, v1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=-1)


def tri_normal(a, b, c):
    """Unit normal of triangle abc, oriented by the vertex order
    (``DeviceTetMesh.cuh:193-199``)."""
    n = cross3(b - a, c - a)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def reflect_point(p, n, d):
    """Mirror point p across the plane {x : n.x = d} (unit normal n);
    insensitive to the sign of (n, d), like the reference's ``triReflect``
    (``DeviceTetMesh.cuh:201-211``) and ``specularReflect``
    (``RTQuery.cu:92-107``)."""
    return p - 2.0 * (dot3(p, n) - d)[..., None] * n


def reflect_vector(v, n):
    """Mirror direction v across a plane with unit normal n."""
    return v - 2.0 * dot3(v, n)[..., None] * n


def tet_volume(a, b, c, d):
    """Signed volume (det/6)."""
    return det4(a, b, c, d) / 6.0
