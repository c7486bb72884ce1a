"""Tetrahedral mesh container and builders (PyTorch port of
``cudaparticlesfoam_tpu/mesh.py``).

The host builders below are copies of the JAX package's numpy path
(``FACE_SLOTS`` .. ``box_points_tets``), so the port never imports the JAX
package, whose ``__init__`` imports jax.  They must stay bit-identical to
it: ``tests/test_torch_mesh.py`` compares every field of the payload.

A :class:`TetMesh` holds torch tensors on one device plus ``host``, the
numpy payload it was uploaded from (the JAX package keeps the same numpy
arrays in its ``host_np`` mirror registry).  Host-side consumers (grid
locator, tuning) read ``mesh.host`` and never copy back from the device.

Row table ``tet_row`` [nt, 20]: cols 0:3 = A, 3:12 = Tinv row-major,
12:15 = tet velocity, 15:19 = neighbour codes as exact float integers
(negative = -(boundary face + 1); meshes must stay under 2^24 tets in
float32), 19 = 4-bit escape mask (bit s = slot s's boundary face absorbs).

ConvexPoly tables (:func:`with_convex_rows`, optional): ``tet_row_cx``
[nt, 24] = outward face normals 0:12 | plane offsets 12:16 | neighbour
codes 16:20 | global face ids 20:24 (exact float integers), and
``tet_row_cxe`` [nt, 24], the convex engine's row cache (``cx_table``):
cols 0:20 of ``tet_row_cx`` | tet velocity 20:23 | 0.

VertexVelocity table (:func:`with_pk_rows`, optional): ``tet_row_pk``
[nt, 29] = A 0:3 | Tinv 3:12 | the 4 vertex velocities v0..v3 12:24 |
neighbour codes 24:28 | escape mask 28.  On the device it is stored once,
as ``tet_row_pk32`` [nt, 32]: the same rows padded with zeros to whole 16 B
chunks (one 128 B line a row in float32), which is the table the
VertexVelocity kernels read; ``tet_row_pk`` is its ``[:, :29]`` view, and
the host payload stays 29 wide.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dtypes import canonical_device, numpy_float

# Gmsh-order local faces: slot i opposite vertex i; outward-oriented for
# positive-volume tets (HostTetMesh.h:350-358).
FACE_SLOTS = np.array([[1, 2, 3], [2, 0, 3], [0, 1, 3], [0, 2, 1]], dtype=np.int64)

# payload entries that are arrays (uploaded) vs python-int meta
ARRAY_FIELDS = (
    "points", "tets", "tet_vel", "vert_vel", "faces", "tet_faces",
    "face_front", "face_back", "tet_a", "tet_tinv", "tet_nbr", "tet_face_n",
    "tet_face_d", "tet_row", "bd_tris", "bd_tet", "bd_patch", "bd_escape",
    "bounds_lo", "bounds_hi",
)
META_FIELDS = ("n_points", "n_tets", "n_faces", "n_bd_faces")
# optional array entries and the row width of each: present once
# with_convex_rows (the first two) or with_pk_rows (the last) has run
CX_ROW_W = 24
PK_ROW_W = 29
PK_TAB_W = 32     # tet_row_pk as stored on the device (module docstring)
OPTIONAL_FIELDS = {"tet_row_cx": CX_ROW_W, "tet_row_cxe": CX_ROW_W, "tet_row_pk": PK_ROW_W}


@dataclasses.dataclass(frozen=True, eq=False)
class TetMesh:
    """Structure-of-arrays mesh on one torch device (fields as in the JAX
    package's ``TetMesh``; ``host`` is the numpy payload)."""

    host: dict
    points: torch.Tensor       # [nv, 3] float
    tets: torch.Tensor         # [nt, 4] int32, positive volume
    tet_vel: torch.Tensor      # [nt, 3] float (TetVelocity)
    vert_vel: torch.Tensor     # [nv, 3] float (VertexVelocity)
    faces: torch.Tensor        # [nf, 3] int32
    tet_faces: torch.Tensor    # [nt, 4] int32
    face_front: torch.Tensor   # [nf] int32
    face_back: torch.Tensor    # [nf] int32
    tet_a: torch.Tensor        # [nt, 3]
    tet_tinv: torch.Tensor     # [nt, 3, 3]
    tet_nbr: torch.Tensor      # [nt, 4] int32 neighbour or -(bdFace+1)
    tet_face_n: torch.Tensor   # [nt, 4, 3]
    tet_face_d: torch.Tensor   # [nt, 4]
    tet_row: torch.Tensor      # [nt, 20] packed hot row (module docstring)
    bd_tris: torch.Tensor      # [nbd, 3] int32
    bd_tet: torch.Tensor       # [nbd] int32
    bd_patch: torch.Tensor     # [nbd] int32
    bd_escape: torch.Tensor    # [nbd] bool: True = absorbing
    bounds_lo: torch.Tensor    # [3]
    bounds_hi: torch.Tensor    # [3]
    n_points: int
    n_tets: int
    n_faces: int
    n_bd_faces: int
    tet_row_cx: torch.Tensor | None = None    # [nt, 24] (module docstring)
    tet_row_cxe: torch.Tensor | None = None   # [nt, 24] convex row cache
    tet_row_pk: torch.Tensor | None = None    # [nt, 29] view of tet_row_pk32
    tet_row_pk32: torch.Tensor | None = None  # [nt, 32] VertexVelocity rows, padded

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def device(self) -> torch.device:
        return self.points.device


# ---------------------------------------------------------------------------
# host-side (numpy) construction — copies of the JAX package's numpy path
# ---------------------------------------------------------------------------


def _cross(a, b):
    """Component-form cross product (same arithmetic as np.cross)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-1
    )


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
    inv = np.stack(
        [
            np.stack([A, B, C], axis=-1),
            np.stack([D, E, F], axis=-1),
            np.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def _canonicalize_winding(points: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Swap the first two vertices of negative-volume tets
    (HostTetMesh.h:334-343)."""
    a, b, c, d = (points[tets[:, i]] for i in range(4))
    vol = np.einsum("ij,ij->i", d - a, _cross(b - a, c - a))
    tets = tets.copy()
    neg = vol < 0.0
    tets[neg, 0], tets[neg, 1] = tets[neg, 1].copy(), tets[neg, 0].copy()
    return tets


def build_face_tables(tets: np.ndarray):
    """Shared-face construction with the reference's front/back parity
    (``HostTetMesh.h:265-304``).  Returns (faces, tet_faces, face_front,
    face_back, bd_face_ids, bd_tet, bd_slot)."""
    nt = tets.shape[0]
    slot_faces = tets[:, FACE_SLOTS]                     # [nt, 4, 3]
    flat = slot_faces.reshape(-1, 3)                     # [4nt, 3]

    # orientation parity via the reference's 3-step sorting network
    f = flat.copy()
    front = np.zeros(len(f), dtype=bool)
    for i, j in ((0, 2), (1, 2), (0, 1)):
        swap = f[:, i] > f[:, j]
        fi, fj = f[swap, i].copy(), f[swap, j].copy()
        f[swap, i], f[swap, j] = fj, fi
        front ^= swap
    sorted_faces = f

    # dedup by sorted triple; one packed int64 key below 2^21 points
    n_pts_max = int(flat.max()) + 1 if len(flat) else 1
    if n_pts_max < (1 << 21):
        key = (
            (sorted_faces[:, 0].astype(np.int64) << 42)
            | (sorted_faces[:, 1].astype(np.int64) << 21)
            | sorted_faces[:, 2].astype(np.int64)
        )
        _, first_idx, inverse, counts = np.unique(
            key, return_index=True, return_inverse=True, return_counts=True
        )
        faces = sorted_faces[first_idx]
    else:
        faces, inverse, counts = np.unique(
            sorted_faces, axis=0, return_inverse=True, return_counts=True
        )
    inverse = inverse.reshape(nt, 4)
    tet_faces = inverse.astype(np.int32)

    tet_ids = np.repeat(np.arange(nt, dtype=np.int32), 4)
    face_front = np.full(len(faces), -1, dtype=np.int32)
    face_back = np.full(len(faces), -1, dtype=np.int32)
    inv_flat = inverse.reshape(-1)
    face_front[inv_flat[front]] = tet_ids[front]
    face_back[inv_flat[~front]] = tet_ids[~front]

    # boundary faces: seen exactly once; numbered in face-id order
    bd_mask = counts == 1
    bd_face_ids = np.nonzero(bd_mask)[0].astype(np.int32)
    bd_code = np.zeros(len(faces), dtype=np.int32)
    bd_code[bd_face_ids] = -(np.arange(len(bd_face_ids), dtype=np.int32) + 1)
    missing_front = bd_mask & (face_front == -1)
    missing_back = bd_mask & (face_back == -1)
    face_front[missing_front] = bd_code[missing_front]
    face_back[missing_back] = bd_code[missing_back]

    # owning (tet, slot) of each boundary face
    order = np.argsort(inv_flat, kind="stable")
    first_idx = np.searchsorted(inv_flat[order], bd_face_ids)
    owner_flat = order[first_idx]
    bd_tet = (owner_flat // 4).astype(np.int32)
    bd_slot = (owner_flat % 4).astype(np.int32)

    return (faces.astype(np.int32), tet_faces, face_front, face_back,
            bd_face_ids, bd_tet, bd_slot)


def _build_walk_table(points, tets, tet_faces, face_front, face_back, bd_face_ids):
    """Per-tet hop data: A, Tinv, neighbour codes, outward face planes."""
    a = points[tets[:, 0]]
    b = points[tets[:, 1]]
    c = points[tets[:, 2]]
    d = points[tets[:, 3]]
    m = np.stack([b - a, c - a, d - a], axis=-1)         # [nt,3,3]
    tinv = _inv3(m)

    nf_front = face_front[tet_faces]                     # [nt,4]
    nf_back = face_back[tet_faces]
    tet_ids = np.arange(tets.shape[0], dtype=np.int32)[:, None]
    nbr = np.where(nf_front == tet_ids, nf_back, nf_front).astype(np.int32)

    slot_pts = points[tets[:, FACE_SLOTS]]               # [nt,4,3verts,3]
    p0, p1, p2 = slot_pts[:, :, 0], slot_pts[:, :, 1], slot_pts[:, :, 2]
    n = _cross(p1 - p0, p2 - p0)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    # explicit sequential dot (not einsum): bit-faithful to the JAX package
    dpl = n[..., 0] * p0[..., 0] + n[..., 1] * p0[..., 1] + n[..., 2] * p0[..., 2]
    return a, tinv, nbr, n, dpl


def from_arrays_host(
    points: np.ndarray,
    tets: np.ndarray,
    tet_vel: np.ndarray | None = None,
    vert_vel: np.ndarray | None = None,
    bd_patch: np.ndarray | None = None,
    dtype=None,
) -> dict:
    """All-numpy mesh payload: field name -> numpy array (final dtypes) or
    python-int meta.  ``dtype`` None = float32."""
    fdtype = numpy_float(dtype)
    points = np.asarray(points, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64)

    tets = _canonicalize_winding(points, tets)
    faces, tet_faces, face_front, face_back, bd_face_ids, bd_tet, bd_slot = (
        build_face_tables(tets)
    )
    a, tinv, nbr, n, dpl = _build_walk_table(
        points, tets, tet_faces, face_front, face_back, bd_face_ids
    )

    nv, nt, nf, nbd = len(points), len(tets), len(faces), len(bd_face_ids)
    if tet_vel is None:
        tet_vel = np.zeros((nt, 3))
    if vert_vel is None:
        vert_vel = np.zeros((nv, 3))
    if bd_patch is None:
        bd_patch = np.zeros(nbd, dtype=np.int32)

    bd_tris = tets[bd_tet[:, None], FACE_SLOTS[bd_slot]].astype(np.int32)

    lo = points.min(axis=0) if nv else np.zeros(3)
    hi = points.max(axis=0) if nv else np.zeros(3)

    row = np.zeros((nt, 20))
    row[:, 0:3] = a
    row[:, 3:12] = tinv.reshape(nt, 9)
    row[:, 12:15] = tet_vel
    row[:, 15:19] = nbr.astype(np.float64)

    def as_f(x):
        return np.asarray(x, dtype=fdtype)

    def as_i(x):
        return np.asarray(x, dtype=np.int32)

    return dict(
        points=as_f(points),
        tets=as_i(tets),
        tet_vel=as_f(tet_vel),
        vert_vel=as_f(vert_vel),
        faces=as_i(faces),
        tet_faces=as_i(tet_faces),
        face_front=as_i(face_front),
        face_back=as_i(face_back),
        tet_a=as_f(a),
        tet_tinv=as_f(tinv),
        tet_nbr=as_i(nbr),
        tet_face_n=as_f(n),
        tet_face_d=as_f(dpl),
        tet_row=as_f(row),
        bd_tris=as_i(bd_tris),
        bd_tet=as_i(bd_tet),
        bd_patch=as_i(bd_patch),
        bd_escape=np.zeros(nbd, dtype=bool),
        bounds_lo=as_f(lo),
        bounds_hi=as_f(hi),
        n_points=nv,
        n_tets=nt,
        n_faces=nf,
        n_bd_faces=nbd,
    )


def _check_f32_codes(n_tets: int, dtype) -> None:
    if n_tets >= (1 << 24) and np.dtype(dtype) == np.float32:
        raise ValueError("float32 row tables need < 2^24 tets (exact codes)")


def _upload(name: str, arr: np.ndarray, dev) -> dict:
    """The tensor fields of host array ``name`` on ``dev``: one tensor of the
    same name, and for ``tet_row_pk`` the padded table with its view."""
    if name == "tet_row_pk":
        padded = np.zeros((arr.shape[0], PK_TAB_W), arr.dtype)
        padded[:, :PK_ROW_W] = arr
        t = torch.from_numpy(padded).to(dev)
        return {"tet_row_pk32": t, "tet_row_pk": t[:, :PK_ROW_W]}
    return {name: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)}


def host_to_device(payload: dict, device=None) -> TetMesh:
    """Upload a :func:`from_arrays_host` payload to ``device`` (default
    the card, ``dtypes.canonical_device``; one copy per field; dtypes
    already final).  ``payload`` values may be any
    array-likes (e.g. the fields of a JAX ``TetMesh``); they are kept as
    numpy in ``mesh.host``.  The convex and VertexVelocity tables ride
    along where the payload has them (not None)."""
    dev = canonical_device(device)
    fields = ARRAY_FIELDS + tuple(k for k in OPTIONAL_FIELDS
                                  if payload.get(k) is not None)
    host = {k: np.array(payload[k]) for k in fields}
    for k in META_FIELDS:
        host[k] = int(payload[k])
    if host["tet_row"].shape[1] != 20:
        raise ValueError(f"tet_row must be [nt, 20], got {host['tet_row'].shape}")
    for k in fields[len(ARRAY_FIELDS):]:
        if host[k].shape != (host["n_tets"], OPTIONAL_FIELDS[k]):
            raise ValueError(f"{k} must be [nt, {OPTIONAL_FIELDS[k]}], got {host[k].shape}")
    _check_f32_codes(host["n_tets"], host["tet_row"].dtype)
    tensors = {}
    for k in fields:
        tensors.update(_upload(k, host[k], dev))
    return TetMesh(host=host, **tensors, **{k: host[k] for k in META_FIELDS})


def from_arrays(points, tets, tet_vel=None, vert_vel=None, bd_patch=None,
                dtype=None, device=None) -> TetMesh:
    """Build a :class:`TetMesh` from raw numpy arrays on ``device``
    (default the card)."""
    return host_to_device(
        from_arrays_host(points, tets, tet_vel=tet_vel, vert_vel=vert_vel,
                         bd_patch=bd_patch, dtype=dtype),
        device,
    )


def box_points_tets(nx: int, ny: int, nz: int):
    """Host-only (points, tets, vert_vel) of the box fixture."""
    xs = np.arange(nx + 1, dtype=np.float64)
    ys = np.arange(ny + 1, dtype=np.float64)
    zs = np.arange(nz + 1, dtype=np.float64)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    center = np.array([nx, ny, nz], dtype=np.float64) / 2.0
    rel = points - center
    norm = np.linalg.norm(rel, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        vert_vel = np.where(norm > 0.0, rel / norm, np.array([1.0, 0.0, 0.0]))

    iz, iy, ix = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )
    v0 = (iz * (nx + 1) * (ny + 1) + iy * (nx + 1) + ix).ravel()
    v1 = v0 + 1
    v2 = v0 + (nx + 1)
    v3 = v1 + (nx + 1)
    v4 = v0 + (nx + 1) * (ny + 1)
    v5 = v1 + (nx + 1) * (ny + 1)
    v6 = v2 + (nx + 1) * (ny + 1)
    v7 = v3 + (nx + 1) * (ny + 1)
    # same 6-tet split as HostTetMesh.h:131-136
    tets = np.stack(
        [
            np.stack([v0, v1, v3, v7], axis=-1),
            np.stack([v0, v1, v7, v5], axis=-1),
            np.stack([v0, v5, v7, v4], axis=-1),
            np.stack([v0, v3, v2, v7], axis=-1),
            np.stack([v0, v6, v4, v7], axis=-1),
            np.stack([v0, v2, v6, v7], axis=-1),
        ],
        axis=1,
    ).reshape(-1, 4)
    return points, tets, vert_vel


def box_mesh(nx: int, ny: int, nz: int, dtype=None, device=None) -> TetMesh:
    """Synthetic box fixture (``HostTetMesh::createBoxMesh``): nx*ny*nz
    hexes, 6 tets each, radial vertex velocity, tet velocity = vertex
    average; on ``device`` (default the card; ``device="cpu"`` for the
    plain versions)."""
    points, tets, vert_vel = box_points_tets(nx, ny, nz)
    tet_vel = vert_vel[tets].mean(axis=1)
    return from_arrays(points, tets, tet_vel=tet_vel, vert_vel=vert_vel,
                       dtype=dtype, device=device)


def read_dataset(vert_fname: str, cell_fname: str, solv_fname: str | None = None,
                 solc_fname: str | None = None, dtype=None, device=None) -> TetMesh:
    """ASCII vert/cell/solution reader (``HostTetMesh::readDataSet``,
    ``HostTetMesh.h:146-262``; JAX ``mesh.read_dataset``): vert.dat (header
    + xyz rows), cell.dat (header + 4 ids), solution.dat (p u v w rows,
    per-vertex or per-cell); the mesh lands on ``device`` (default the card)."""
    with open(vert_fname) as fh:
        nv = int(fh.readline().split()[-1])
        fh.readline()  # column comment
        points = np.loadtxt(fh, max_rows=nv, ndmin=2)
    with open(cell_fname) as fh:
        nt = int(fh.readline().split()[-1])
        fh.readline()
        tets = np.loadtxt(fh, dtype=np.int64, max_rows=nt, ndmin=2)

    vert_vel = tet_vel = None
    if solv_fname:
        with open(solv_fname) as fh:
            fh.readline()
            vert_vel = np.loadtxt(fh, max_rows=nv, ndmin=2)[:, 1:4]
    elif solc_fname:
        with open(solc_fname) as fh:
            fh.readline()
            tet_vel = np.loadtxt(fh, max_rows=nt, ndmin=2)[:, 1:4]
    return from_arrays(points, tets, tet_vel=tet_vel, vert_vel=vert_vel, dtype=dtype,
                       device=device)


def _with_host(mesh: TetMesh, updates: dict) -> TetMesh:
    """New mesh with host fields replaced and re-uploaded."""
    host = dict(mesh.host)
    host.update(updates)
    kw = {}
    for k, v in updates.items():
        kw.update(_upload(k, v, mesh.device))
    return dataclasses.replace(mesh, host=host, **kw)


def replace_velocity(mesh: TetMesh, tet_vel=None, vert_vel=None) -> TetMesh:
    """Velocity refresh (``cudaUpdateVelocity``, ``particles.cu:733-749``):
    a mesh with new velocity arrays; ``tet_vel`` also lands in tet_row
    cols 12:15 and, once :func:`with_convex_rows` has run, in tet_row_cxe
    cols 20:23; ``vert_vel`` also lands in tet_row_pk cols 12:24 once
    :func:`with_pk_rows` has run."""
    fdt = mesh.host["points"].dtype

    def as_np(x):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return x.astype(fdt)

    updates = {}
    if tet_vel is not None:
        tv = as_np(tet_vel)
        row = mesh.host["tet_row"].copy()
        row[:, 12:15] = tv
        updates["tet_vel"] = tv
        updates["tet_row"] = row
        if "tet_row_cxe" in mesh.host:
            cxe = mesh.host["tet_row_cxe"].copy()
            cxe[:, 20:23] = tv
            updates["tet_row_cxe"] = cxe
    if vert_vel is not None:
        vv = as_np(vert_vel)
        updates["vert_vel"] = vv
        if "tet_row_pk" in mesh.host:
            pk = mesh.host["tet_row_pk"].copy()
            pk[:, 12:24] = vv[mesh.host["tets"]].reshape(mesh.n_tets, 12)
            updates["tet_row_pk"] = pk
    return _with_host(mesh, updates)


def set_boundary_escape(mesh: TetMesh, escape_patch_ids) -> TetMesh:
    """Mark boundary faces of the given ``bd_patch`` ids as absorbing.

    Sets every place the port reads: ``bd_escape`` (the rare stage's
    reflector) and the 4-bit mask in tet_row col 19 and, where
    :func:`with_pk_rows` has run, tet_row_pk col 28 (the stream kernel's
    inline bounce), as the JAX package's ``set_boundary_escape`` does."""
    ids = np.asarray(list(escape_patch_ids))
    nbd = mesh.n_bd_faces
    esc = (np.isin(mesh.host["bd_patch"], ids) if len(ids)
           else np.zeros(nbd, dtype=bool))
    nbr = mesh.host["tet_nbr"]
    bdi = np.clip(-nbr - 1, 0, max(nbd - 1, 0))
    bits = (nbr < 0) & esc[bdi]
    maskv = (bits.astype(np.int64) * np.array([1, 2, 4, 8])).sum(axis=1)
    row = mesh.host["tet_row"].copy()
    row[:, 19] = maskv
    updates = {"bd_escape": esc, "tet_row": row}
    if "tet_row_pk" in mesh.host:
        pk = mesh.host["tet_row_pk"].copy()
        pk[:, 28] = maskv
        updates["tet_row_pk"] = pk
    return _with_host(mesh, updates)


def _inv3_torch(m):
    """:func:`_inv3` on tensors (the same adjugate formula, elementwise
    only), for the geometry refresh on the mesh's device."""
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
    inv = torch.stack([torch.stack([A, B, C], dim=-1), torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def refresh_geometry(mesh: TetMesh, new_points) -> TetMesh:
    """Recompute the geometric tables for MOVED vertices (same topology;
    JAX ``mesh.refresh_geometry``).

    The moving-mesh path (``mesh.controlledUpdate()``,
    ``cudaParticlesPimpleFoam.C:147``): tets, faces and neighbour codes are
    unchanged, so only A, Tinv, the face planes, the geometry columns of
    every row table the mesh holds (``tet_row`` 0:12, ``tet_row_pk32`` 0:12,
    ``tet_row_cx`` / ``tet_row_cxe`` 0:16) and the bounds are recomputed, on
    the mesh's device, from ``new_points`` (cast to the mesh's dtype first,
    as JAX does).  The host payload takes the new tables too (one copy
    back), so that a later :func:`replace_velocity` starts from them."""
    pts = torch.as_tensor(np.asarray(new_points) if not torch.is_tensor(new_points)
                          else new_points, dtype=mesh.dtype, device=mesh.device)
    tets = mesh.tets.long()
    nt = mesh.n_tets
    a = pts[tets[:, 0]]
    m3 = torch.stack([pts[tets[:, 1]] - a, pts[tets[:, 2]] - a, pts[tets[:, 3]] - a], dim=-1)
    tinv = _inv3_torch(m3)
    slot_pts = pts[tets[:, torch.as_tensor(FACE_SLOTS, device=mesh.device)]]   # [nt, 4, 3, 3]
    p0, p1, p2 = slot_pts[:, :, 0], slot_pts[:, :, 1], slot_pts[:, :, 2]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    # the host build's sequential dot
    dpl = n[..., 0] * p0[..., 0] + n[..., 1] * p0[..., 1] + n[..., 2] * p0[..., 2]
    geo = torch.cat([a, tinv.reshape(nt, 9)], dim=1)
    kw = {"points": pts, "tet_a": a, "tet_tinv": tinv, "tet_face_n": n, "tet_face_d": dpl,
          "bounds_lo": pts.min(dim=0).values, "bounds_hi": pts.max(dim=0).values}
    row = mesh.tet_row.clone()
    row[:, 0:12] = geo
    kw["tet_row"] = row
    if mesh.tet_row_pk32 is not None:
        pk = mesh.tet_row_pk32.clone()
        pk[:, 0:12] = geo
        kw["tet_row_pk32"], kw["tet_row_pk"] = pk, pk[:, :PK_ROW_W]
    planes = torch.cat([n.reshape(nt, 12), dpl], dim=1)
    for name in ("tet_row_cx", "tet_row_cxe"):
        if getattr(mesh, name) is not None:
            t = getattr(mesh, name).clone()
            t[:, 0:16] = planes
            kw[name] = t
    host = dict(mesh.host)
    for k, v in kw.items():
        if k in host:
            host[k] = v.detach().cpu().numpy()
    return dataclasses.replace(mesh, host=host, **kw)


def to_device(mesh: TetMesh, device) -> TetMesh:
    """``mesh`` with every tensor on ``device`` (the mesh itself when it is
    there already); ``tet_row_pk`` stays a view of the moved
    ``tet_row_pk32``, and the host payload is shared."""
    device = torch.device(device)
    if mesh.device == device:
        return mesh
    kw = {}
    for f in dataclasses.fields(mesh):
        v = getattr(mesh, f.name)
        if torch.is_tensor(v) and f.name != "tet_row_pk":
            kw[f.name] = v.to(device)
    if mesh.tet_row_pk32 is not None:
        kw["tet_row_pk"] = kw["tet_row_pk32"][:, :PK_ROW_W]
    return dataclasses.replace(mesh, **kw)


def with_convex_rows(mesh: TetMesh) -> TetMesh:
    """Attach the ConvexPoly row tables ``tet_row_cx`` and ``tet_row_cxe``
    (module docstring; JAX ``mesh.with_convex_rows``), built on the host
    from the mesh's own numpy payload.  A mesh that has them is returned
    as is."""
    if mesh.tet_row_cx is not None:
        return mesh
    h = mesh.host
    nt, fdt = mesh.n_tets, h["points"].dtype
    _check_f32_codes(nt, fdt)
    row = np.concatenate([
        h["tet_face_n"].reshape(nt, 12),
        h["tet_face_d"],
        h["tet_nbr"].astype(fdt),
        h["tet_faces"].astype(fdt),
    ], axis=1)
    cxe = np.concatenate([row[:, 0:20], h["tet_vel"].astype(fdt),
                          np.zeros((nt, 1), fdt)], axis=1)
    return _with_host(mesh, {"tet_row_cx": row, "tet_row_cxe": cxe})


def with_pk_rows(mesh: TetMesh) -> TetMesh:
    """Attach the VertexVelocity row table ``tet_row_pk`` [nt, 29] and its
    padded store ``tet_row_pk32`` (module docstring; JAX
    ``mesh.with_pk_rows``), built on the host from the
    mesh's own numpy payload: one row serves the barycentric test, the
    blend of the 4 vertex velocities (``particles.cu:245-313``), the
    neighbour step, the reflection plane and the absorb test, as
    ``tet_row`` does for TetVelocity.  The mask column is copied from
    ``tet_row`` col 19, so an earlier :func:`set_boundary_escape` is kept.
    A mesh that has the table is returned as is."""
    if mesh.tet_row_pk is not None:
        return mesh
    h = mesh.host
    nt = mesh.n_tets
    _check_f32_codes(nt, h["points"].dtype)
    row = np.concatenate([
        h["tet_row"][:, 0:12],
        h["vert_vel"][h["tets"]].reshape(nt, 12),
        h["tet_row"][:, 15:19],
        h["tet_row"][:, 19:20],
    ], axis=1)
    return _with_host(mesh, {"tet_row_pk": row})
