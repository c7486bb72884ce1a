"""OpenFOAM polyMesh reader/writer + tetrahedralization bridge.

The replacement for the solver-embedded OpenFOAM->CUDA
mesh bridge (``src/initCuda.H:74-124``): read ``constant/polyMesh`` directly
in Python, compute OpenFOAM-identical face/cell centres, decompose every
cell into tets around its centre (the reference calls
``polyMeshTetDecomposition::cellTetIndices``: per cell face, fan triangles
with the cell centre as apex — 12 tets per hex), and hand the arrays to
:func:`cudaparticlesfoam_tpu_torch.mesh.from_arrays`.

Boundary patch names/types are carried through onto the tet-mesh boundary
faces (``bd_patch``), which turns the reference's reflect-at-all-boundaries
TODO (``RTQuery.cu:165-166``) into data.

A copy of ``cudaparticlesfoam_tpu/io/polymesh.py`` (numpy only): the
builders hand their payload to the port's ``mesh.from_arrays_host`` and
upload it with the port's ``mesh.host_to_device``.  Pinned to the original
by ``tests/test_torch_io.py`` (round trips, geometry, the tet payload field
for field).  Where ``g++`` exists, the base points come from the port's own
build of ``csrc/meshbuild.cpp`` (``io/native.py``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from . import foamfile


def _cross(a, b):
    """Component-form cross product (see mesh._cross): np.cross pays
    generic broadcast machinery that dominates big-mesh builds."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-1
    )


def _nums(text: str, dtype=np.float64) -> np.ndarray:
    """Fast whitespace-separated number parsing (paren chars -> spaces).

    numpy's bulk conversion measured faster than the native strtod scanner
    (csrc/fastio.cpp keeps parse_doubles/parse_longs for memory-bound
    cases; the VTU writer is where native wins ~14x)."""
    cleaned = text.replace("(", " ").replace(")", " ")
    return np.array(cleaned.split(), dtype=dtype)


@dataclasses.dataclass
class PolyMesh:
    points: np.ndarray        # [np, 3] float64
    face_verts: np.ndarray    # flat vertex ids
    face_offsets: np.ndarray  # [nfaces+1]
    owner: np.ndarray         # [nfaces]
    neighbour: np.ndarray     # [n_internal]
    patches: list             # [(name, type, start_face, n_faces)]
    cell_zones: dict | None = None   # {name: cell-id array} (cellZones file)

    @property
    def n_faces(self):
        return len(self.face_offsets) - 1

    @property
    def n_internal_faces(self):
        return len(self.neighbour)

    @property
    def n_cells(self):
        n = int(self.owner.max()) + 1 if len(self.owner) else 0
        if len(self.neighbour):
            n = max(n, int(self.neighbour.max()) + 1)
        return n

    def face(self, i):
        return self.face_verts[self.face_offsets[i] : self.face_offsets[i + 1]]


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _read_raw(path: str) -> bytes:
    """Read file bytes; transparently falls back to ``path + '.gz'``
    (OpenFOAM ``writeCompression on`` output)."""
    if os.path.exists(path):
        with open(path, "rb") as fh:
            return fh.read()
    gz = path + ".gz"
    if os.path.exists(gz):
        import gzip

        with gzip.open(gz, "rb") as fh:
            return fh.read()
    raise FileNotFoundError(path)


def _parse_header_bytes(data: bytes):
    """Extract the FoamFile header from raw bytes.

    Returns (header_dict, end_offset).  The header itself is always ascii,
    even in ``format binary`` files; keys of interest: ``format`` ("ascii" /
    "binary"), ``class``, and ``arch`` (label/scalar widths, e.g.
    ``"LSB;label=32;scalar=64"``).
    """
    m = re.search(rb"FoamFile\s*\{(.*?)\}", data[:4096], re.DOTALL)
    if not m:
        return {}, 0
    hdr = {}
    for em in re.finditer(rb"([\w]+)\s+([^;]+);", m.group(1)):
        hdr[em.group(1).decode()] = em.group(2).decode().strip().strip('"')
    return hdr, m.end()


def _arch_sizes(hdr: dict):
    """(label_dtype, scalar_dtype) from the header's arch string.

    OpenFOAM defaults: 32-bit labels, 64-bit scalars, little-endian."""
    arch = hdr.get("arch", "")
    label = np.dtype("<i8") if "label=64" in arch else np.dtype("<i4")
    scalar = np.dtype("<f4") if "scalar=32" in arch else np.dtype("<f8")
    return label, scalar


def _skip_ws(data: bytes, pos: int) -> int:
    while pos < len(data) and data[pos : pos + 1].isspace():
        pos += 1
    return pos


def _read_bin_list(data: bytes, pos: int, dtype: np.dtype):
    """Binary token list: ascii count, '(', count raw elements, ')'.

    Returns (flat array, position after ')')."""
    pos = _skip_ws(data, pos)
    m = re.match(rb"\d+", data[pos:])
    if not m:
        raise ValueError("expected list count")
    count = int(m.group(0))
    pos = _skip_ws(data, pos + m.end())
    if data[pos : pos + 1] != b"(":
        raise ValueError("expected '(' after list count")
    pos += 1
    nbytes = count * dtype.itemsize
    arr = np.frombuffer(data[pos : pos + nbytes], dtype=dtype)
    pos += nbytes
    pos = _skip_ws(data, pos)
    if data[pos : pos + 1] != b")":
        raise ValueError("expected ')' after binary list data")
    return arr, pos + 1


def _read_foam_body(path: str) -> str:
    text = _read_raw(path).decode("utf-8", errors="replace")
    text = foamfile.strip_comments(text)
    # drop the FoamFile header block
    m = re.search(r"FoamFile\s*\{[^}]*\}", text)
    if m:
        text = text[m.end() :]
    return text


def _read_count_and_parens(text: str):
    """Extract (count, inner-of-outermost-parens) from a list file body."""
    m = re.search(r"(\d+)\s*\(", text)
    if not m:
        raise ValueError("no list found")
    count = int(m.group(1))
    start = m.end()
    # outer list ends at the matching close paren: find from the END
    end = text.rfind(")")
    return count, text[start:end]


def read_points(path: str) -> np.ndarray:
    raw = _read_raw(path)
    hdr, end = _parse_header_bytes(raw)
    if hdr.get("format") == "binary":
        _, scalar = _arch_sizes(hdr)
        flat, _ = _read_bin_list(raw, end, scalar)
        return flat.astype(np.float64).reshape(-1, 3)
    text = _read_foam_body(path)
    count, inner = _read_count_and_parens(text)
    pts = _nums(inner).reshape(-1, 3)
    assert len(pts) == count, f"points count mismatch {len(pts)} vs {count}"
    return pts


def read_label_list(path: str) -> np.ndarray:
    raw = _read_raw(path)
    hdr, end = _parse_header_bytes(raw)
    if hdr.get("format") == "binary":
        label, _ = _arch_sizes(hdr)
        vals, _ = _read_bin_list(raw, end, label)
        return vals.astype(np.int64)
    text = _read_foam_body(path)
    count, inner = _read_count_and_parens(text)
    vals = _nums(inner, np.int64)
    assert len(vals) == count
    return vals


def read_faces(path: str):
    """faces file -> (flat vertex ids, offsets[nfaces+1]).

    Ascii ``faceList``: ``N ( 4(a b c d) 3(a b c) ... )``.  Binary (and
    compact-ascii) ``faceCompactIOList``: two label lists — offsets then
    the flat vertex stream (what ``foamFormatConvert``/binary cases write).
    """
    raw = _read_raw(path)
    hdr, end = _parse_header_bytes(raw)
    if hdr.get("format") == "binary":
        label, _ = _arch_sizes(hdr)
        offsets, pos = _read_bin_list(raw, end, label)
        flat, _ = _read_bin_list(raw, pos, label)
        return flat.astype(np.int64), offsets.astype(np.int64)
    text = _read_foam_body(path)
    if "Compact" in hdr.get("class", ""):
        # ascii compact form: offsets list then flat list (no nesting)
        m1 = re.search(r"(\d+)\s*\(", text)
        s1 = m1.end()
        e1 = text.index(")", s1)
        offsets = _nums(text[s1:e1], np.int64)
        m2 = re.search(r"(\d+)\s*\(", text[e1 + 1 :])
        s2 = e1 + 1 + m2.end()
        e2 = text.index(")", s2)
        flat = _nums(text[s2:e2], np.int64)
        assert len(offsets) == int(m1.group(1)) and len(flat) == int(m2.group(1))
        return flat, offsets
    count, inner = _read_count_and_parens(text)
    flat = _nums(inner, np.int64)
    # walk the count-prefixed records vectorized-ish
    offsets = np.zeros(count + 1, dtype=np.int64)
    sizes = np.zeros(count, dtype=np.int64)
    idx = 0
    # quick path: uniform face size
    if count and len(flat) % count == 0:
        k = len(flat) // count - 1
        if k >= 3 and (flat[:: k + 1] == k).all():
            sizes[:] = k
            verts = flat.reshape(count, k + 1)[:, 1:].ravel()
            offsets[1:] = np.cumsum(sizes)
            return verts, offsets
    verts_list = []
    for i in range(count):
        k = flat[idx]
        sizes[i] = k
        verts_list.append(flat[idx + 1 : idx + 1 + k])
        idx += 1 + k
    offsets[1:] = np.cumsum(sizes)
    return np.concatenate(verts_list), offsets


def read_boundary(path: str) -> list:
    text = _read_foam_body(path)
    patches = []
    # boundary file: N ( name { ... } name { ... } )
    m = re.search(r"\d+\s*\(", text)
    body = text[m.end() : text.rfind(")")]
    for pm in re.finditer(r"([\w.\-]+)\s*\{([^}]*)\}", body):
        name = pm.group(1)
        entries = dict(
            re.findall(r"(\w+)\s+([^;]+);", pm.group(2))
        )
        patches.append(
            (
                name,
                entries.get("type", "patch").strip(),
                int(entries["startFace"]),
                int(entries["nFaces"]),
            )
        )
    return patches


def read_polymesh(mesh_dir: str) -> PolyMesh:
    """Read constant/polyMesh ascii files."""
    points = read_points(os.path.join(mesh_dir, "points"))
    face_verts, face_offsets = read_faces(os.path.join(mesh_dir, "faces"))
    owner = read_label_list(os.path.join(mesh_dir, "owner"))
    neighbour = read_label_list(os.path.join(mesh_dir, "neighbour"))
    patches = read_boundary(os.path.join(mesh_dir, "boundary"))
    zones = read_cell_zones(mesh_dir)     # {} when the file is absent
    return PolyMesh(points, face_verts, face_offsets, owner, neighbour,
                    patches, cell_zones=zones or None)


def write_cell_zones(zones: dict, mesh_dir: str) -> None:
    from . import foamfile

    with open(os.path.join(mesh_dir, "cellZones"), "w") as fh:
        fh.write(foamfile._HEADER)
        fh.write(
            "FoamFile\n{\n    version 2.0;\n    format ascii;\n"
            "    class regIOobject;\n"
            '    location "constant/polyMesh";\n    object cellZones;\n}\n\n'
        )
        fh.write(f"{len(zones)}\n(\n")
        for name, ids in zones.items():
            ids = np.asarray(ids, np.int64)
            fh.write(f"{name}\n{{\n    type cellZone;\n")
            fh.write(f"cellLabels      List<label>\n{len(ids)}\n(\n")
            fh.write("\n".join(map(str, ids.tolist())))
            fh.write("\n);\n}\n\n")
        fh.write(")\n")


# ---------------------------------------------------------------------------
# geometry: OpenFOAM-identical face/cell centres
# ---------------------------------------------------------------------------


def face_centres_areas(pm: PolyMesh):
    """Face centroids and area vectors, OpenFOAM algorithm
    (primitiveMeshFaceCentresAndAreas): triangle-fan around the estimated
    centre with area weighting; exact centroid for triangles.

    Hot on big meshes — dispatches to the OpenMP C++ kernel
    (csrc/meshbuild.cpp) when the toolchain is available; the numpy path
    below is the reference implementation and the fallback."""
    from . import native

    nat = native.face_centres_areas(pm.points, pm.face_verts, pm.face_offsets)
    if nat is not None:
        return nat
    nf = pm.n_faces
    ctrs = np.zeros((nf, 3))
    areas = np.zeros((nf, 3))
    sizes = np.diff(pm.face_offsets)
    pts = pm.points

    # group faces by size for vectorization
    for k in np.unique(sizes):
        sel = np.nonzero(sizes == k)[0]
        idx = (
            pm.face_offsets[sel][:, None] + np.arange(k)[None, :]
        )
        fv = pm.face_verts[idx]                       # [m, k]
        p = pts[fv]                                   # [m, k, 3]
        if k == 3:
            ctrs[sel] = p.mean(axis=1)
            areas[sel] = 0.5 * _cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            continue
        c_est = p.mean(axis=1)                        # [m, 3]
        p_next = np.roll(p, -1, axis=1)
        n = _cross(p_next - p, c_est[:, None, :] - p)   # [m, k, 3]
        a = np.linalg.norm(n, axis=-1)                # [m, k]
        c = p + p_next + c_est[:, None, :]            # [m, k, 3]
        sum_a = a.sum(axis=1)
        sum_ac = (a[..., None] * c).sum(axis=1)
        sum_n = n.sum(axis=1)
        # degenerate faces fall back to c_est (OpenFOAM uses a SMALL guard)
        good = sum_a > 1e-300
        ctrs[sel] = np.where(
            good[:, None], sum_ac / (3.0 * np.maximum(sum_a, 1e-300))[:, None], c_est
        )
        areas[sel] = 0.5 * sum_n
    return ctrs, areas


def cell_centres_volumes(pm: PolyMesh, f_ctrs=None, f_areas=None):
    """Cell centroids and volumes, OpenFOAM algorithm
    (primitiveMeshCellCentresAndVols): pyramid decomposition over faces
    about the estimated centre.  These centres are the tet apex vertices of
    the reference bridge (``src/initCuda.H:119-124`` pushes ``mesh.C()``)."""
    if f_ctrs is None:
        f_ctrs, f_areas = face_centres_areas(pm)
    nc = pm.n_cells
    n_int = pm.n_internal_faces

    # estimated centre: mean of face centres over each cell
    c_est = np.zeros((nc, 3))
    n_cell_faces = np.zeros(nc)
    np.add.at(c_est, pm.owner, f_ctrs)
    np.add.at(n_cell_faces, pm.owner, 1.0)
    np.add.at(c_est, pm.neighbour, f_ctrs[:n_int])
    np.add.at(n_cell_faces, pm.neighbour, 1.0)
    c_est /= n_cell_faces[:, None]

    ctrs = np.zeros((nc, 3))
    vols = np.zeros(nc)
    # owner side
    pyr3 = np.einsum("ij,ij->i", f_areas, f_ctrs - c_est[pm.owner])
    pyr_c = 0.75 * f_ctrs + 0.25 * c_est[pm.owner]
    np.add.at(ctrs, pm.owner, pyr3[:, None] * pyr_c)
    np.add.at(vols, pm.owner, pyr3)
    # neighbour side (reversed orientation)
    pyr3n = np.einsum(
        "ij,ij->i", f_areas[:n_int], c_est[pm.neighbour] - f_ctrs[:n_int]
    )
    pyr_cn = 0.75 * f_ctrs[:n_int] + 0.25 * c_est[pm.neighbour]
    np.add.at(ctrs, pm.neighbour, pyr3n[:, None] * pyr_cn)
    np.add.at(vols, pm.neighbour, pyr3n)

    ctrs /= np.maximum(vols, 1e-300)[:, None]
    vols *= 1.0 / 3.0
    return ctrs, vols


# ---------------------------------------------------------------------------
# tet decomposition
# ---------------------------------------------------------------------------


def _tet_quality(apex, p0, p1, p2):
    """OpenFOAM ``tetrahedron::quality()``: signed volume over the volume
    of the regular tet sharing the circumsphere —
    ``mag() / (8/(9*sqrt(3)) * circumRadius^3 + ROOTVSMALL)``.  Shapes
    broadcast; degenerate tets get ~0 (huge circumradius)."""
    e1 = p0 - apex
    e2 = p1 - apex
    e3 = p2 - apex
    vol = np.einsum("...i,...i->...", e1, _cross(e2, e3)) / 6.0
    # circumcentre offset u solves [e1;e2;e3] u = 0.5*[|e1|^2,|e2|^2,|e3|^2]
    det = np.einsum("...i,...i->...", e1, _cross(e2, e3))
    # adjugate solve (avoids np.linalg exceptions on degenerate batches)
    r1 = 0.5 * np.einsum("...i,...i->...", e1, e1)
    r2 = 0.5 * np.einsum("...i,...i->...", e2, e2)
    r3 = 0.5 * np.einsum("...i,...i->...", e3, e3)
    c23 = _cross(e2, e3)
    c31 = _cross(e3, e1)
    c12 = _cross(e1, e2)
    safe_det = np.where(np.abs(det) > 1e-300, det, 1e-300)
    u = (
        r1[..., None] * c23 + r2[..., None] * c31 + r3[..., None] * c12
    ) / safe_det[..., None]
    rc = np.sqrt(np.einsum("...i,...i->...", u, u))
    rc = np.where(np.abs(det) > 1e-300, rc, 1e30)
    rc = np.minimum(rc, 1e30)
    return vol / (8.0 / (9.0 * np.sqrt(3.0)) * rc**3 + 1e-300)


def face_base_points(pm: PolyMesh, cell_ctrs) -> np.ndarray:
    """Quality-driven per-face tet base point
    (``polyMeshTetDecomposition::findSharedBasePoint``/``findBasePoint``
    semantics, feeding ``cellTetIndices`` at ``initCuda.H:88-92``): for
    each face, pick the vertex whose fan maximizes the MINIMUM tet quality
    over both adjacent cells (owner only at boundaries).  On regular hexes
    every candidate ties and vertex 0 wins — identical to a face[0] fan —
    so this only changes tet shapes on skewed polyhedral cells.

    Returns base LOCAL index per face [nf].

    Dispatches to the OpenMP C++ kernel (csrc/meshbuild.cpp) when the
    toolchain is available — this is the hottest host step of a cold case
    load at large scale; the numpy path below is the reference
    implementation and the fallback.
    """
    from . import native

    nat = native.face_base_points(
        pm.points, pm.face_verts, pm.face_offsets, pm.owner, pm.neighbour,
        pm.n_internal_faces, cell_ctrs,
    )
    if nat is not None:
        return nat
    sizes = np.diff(pm.face_offsets)
    n_int = pm.n_internal_faces
    base = np.zeros(pm.n_faces, dtype=np.int64)
    pts = pm.points
    for k in np.unique(sizes):
        if k == 3:
            continue                      # triangles: any base is the fan
        sel = np.nonzero(sizes == k)[0]
        idx = pm.face_offsets[sel][:, None] + np.arange(k)[None, :]
        fverts = pm.face_verts[idx]                      # [m, k]
        m = len(sel)
        # rolled vertex ids for every candidate base: [m, k(cand), k]
        roll = (np.arange(k)[:, None] + np.arange(k)[None, :]) % k
        cand = fverts[:, roll]                           # [m, k, k]
        p = pts[cand]                                    # [m, k, k, 3]
        b = p[:, :, 0:1]                                 # base point
        pa = p[:, :, 1 : k - 1]                          # fan edges
        pb = p[:, :, 2:k]
        cc_own = cell_ctrs[pm.owner[sel]][:, None, None]   # [m,1,1,3]
        q_own = _tet_quality(cc_own, b, pa, pb)          # [m, k, k-2]
        q = q_own.min(axis=2)                            # [m, k]
        is_int = sel < n_int
        if is_int.any():
            cc_nei = cell_ctrs[pm.neighbour[sel[is_int]]][:, None, None]
            # neighbour side sees the face reversed: swap the fan edge
            q_nei = _tet_quality(
                cc_nei, b[is_int], pb[is_int], pa[is_int]
            ).min(axis=2)
            q[is_int] = np.minimum(q[is_int], q_nei)
        base[sel] = np.argmax(q, axis=1)
    return base


def tet_decompose(pm: PolyMesh, cell_ctrs=None, quality_base: bool = True):
    """Decompose each cell into tets (cellCentre, basePt, pA, pB).

    ``polyMeshTetDecomposition::cellTetIndices`` as consumed by
    ``src/initCuda.H:86-110``: per cell, per face, fan-triangulate the face
    around its base point and form a tet with the cell centre.  Hexes give
    12 tets/cell (``tetsPerCell``, ``initCuda.H:64``).  The base point is
    OpenFOAM's quality-driven shared base point (:func:`face_base_points`);
    ``quality_base=False`` falls back to a plain face[0] fan (identical on
    regular hexes).  Winding is canonicalized downstream.

    Returns (tets[nt,4] indices into [points ++ cellCentres], tet_cell[nt],
    tet_patch[nt] — patch id of the face the tet was built from, -1 for
    internal faces).
    """
    if cell_ctrs is None:
        cell_ctrs, _ = cell_centres_volumes(pm)
    n_pts = len(pm.points)
    sizes = np.diff(pm.face_offsets)
    n_int = pm.n_internal_faces
    nf = pm.n_faces
    base_pts = (
        face_base_points(pm, cell_ctrs)
        if quality_base
        else np.zeros(nf, dtype=np.int64)
    )

    # patch id per mesh face
    face_patch = np.full(nf, -1, dtype=np.int64)
    for pi, (_, _, start, cnt) in enumerate(pm.patches):
        face_patch[start : start + cnt] = pi

    tets = []
    tet_cell = []
    tet_patch = []
    for k in np.unique(sizes):
        sel = np.nonzero(sizes == k)[0]
        idx = pm.face_offsets[sel][:, None] + np.arange(k)[None, :]
        fv = pm.face_verts[idx]                          # [m, k]
        # rotate each face so its chosen base point leads the fan
        roll_idx = (base_pts[sel][:, None] + np.arange(k)[None, :]) % k
        fv = np.take_along_axis(fv, roll_idx, axis=1)
        base = fv[:, 0]
        tri_a = fv[:, 1 : k - 1]                         # [m, k-2]
        tri_b = fv[:, 2:k]
        m = len(sel)
        own = pm.owner[sel]
        # owner-side tets: apex = owner cell centre; face points are ordered
        # outward of the owner, keep (base, a, b)
        t_own = np.stack(
            [
                np.broadcast_to((n_pts + own)[:, None], tri_a.shape),
                np.broadcast_to(base[:, None], tri_a.shape),
                tri_a,
                tri_b,
            ],
            axis=-1,
        ).reshape(-1, 4)
        tets.append(t_own)
        tet_cell.append(np.repeat(own, k - 2))
        tet_patch.append(np.repeat(face_patch[sel], k - 2))
        # neighbour-side tets for internal faces: reversed triangles
        int_sel = sel < n_int
        if int_sel.any():
            nei = pm.neighbour[sel[int_sel]]
            t_nei = np.stack(
                [
                    np.broadcast_to(
                        (n_pts + nei)[:, None], tri_a[int_sel].shape
                    ),
                    np.broadcast_to(base[int_sel][:, None], tri_a[int_sel].shape),
                    tri_b[int_sel],
                    tri_a[int_sel],
                ],
                axis=-1,
            ).reshape(-1, 4)
            tets.append(t_nei)
            tet_cell.append(np.repeat(nei, k - 2))
            tet_patch.append(np.full(len(nei) * (k - 2), -1, dtype=np.int64))

    tets = np.concatenate(tets)
    tet_cell = np.concatenate(tet_cell)
    tet_patch = np.concatenate(tet_patch)
    # order tets by cell (then stable by construction order) so per-cell
    # velocity replication is a simple repeat, like the reference's layout
    order = np.argsort(tet_cell, kind="stable")
    return tets[order], tet_cell[order], tet_patch[order]


def mesh_host_from_polymesh(
    pm: PolyMesh, u_cells: np.ndarray | None = None, dtype=None
):
    """All-numpy tet-mesh payload from a polyMesh (see
    :func:`cudaparticlesfoam_tpu_torch.mesh.from_arrays_host`).  Returns
    ``(host_payload, tet_cell)``; upload with
    :func:`cudaparticlesfoam_tpu_torch.mesh.host_to_device`."""
    from .. import mesh as meshlib

    cell_ctrs, _ = cell_centres_volumes(pm)
    tets, tet_cell, tet_patch = tet_decompose(pm, cell_ctrs)
    points = np.concatenate([pm.points, cell_ctrs], axis=0)
    tet_vel = None
    if u_cells is not None:
        tet_vel = np.asarray(u_cells)[tet_cell]

    host = meshlib.from_arrays_host(points, tets, tet_vel=tet_vel, dtype=dtype)

    # patch tags: boundary tets' outer triangle lies on the source face.
    # Match mesh.bd_tris (sorted triple key) against boundary-origin tets'
    # outer triangles.
    bd_tris = np.sort(host["bd_tris"], axis=1)
    src = np.nonzero(tet_patch >= 0)[0]
    src_tris = np.sort(tets[src][:, 1:4], axis=1)
    all_tris = np.concatenate([src_tris, bd_tris])
    if len(points) < (1 << 21):
        # packed-key dedup (HostTetMesh.h:279 trick) — ~5x faster than the
        # axis=0 row unique at reference-coupled scale
        key = (
            (all_tris[:, 0].astype(np.int64) << 42)
            | (all_tris[:, 1].astype(np.int64) << 21)
            | all_tris[:, 2].astype(np.int64)
        )
        _, inv = np.unique(key, return_inverse=True)
    else:
        _, inv = np.unique(all_tris, axis=0, return_inverse=True)
    inv_src, inv_bd = inv[: len(src)], inv[len(src) :]
    lut = np.zeros(int(inv.max()) + 1 if len(inv) else 1, dtype=np.int32)
    lut[inv_src] = tet_patch[src].astype(np.int32)
    host["bd_patch"] = lut[inv_bd].astype(np.int32)
    return host, tet_cell


def mesh_from_polymesh(pm: PolyMesh, u_cells: np.ndarray | None = None, dtype=None,
                       device=None):
    """Build a :class:`~cudaparticlesfoam_tpu_torch.mesh.TetMesh` from a
    polyMesh, on ``device`` (default the card, ``dtypes.canonical_device``).

    Vertex array = mesh points ++ cell centres (``initCuda.H:112-124``);
    per-tet velocity = owning cell's U (``initCuda.H:106-108``).  Boundary
    patch tags are transferred onto tet-mesh boundary faces.

    Returns (tet_mesh, tet_cell) — keep ``tet_cell`` to refresh velocities
    from new U snapshots (replaces the x12 replication at ``advect.H:44-55``).
    """
    from .. import mesh as meshlib

    host, tet_cell = mesh_host_from_polymesh(pm, u_cells=u_cells, dtype=dtype)
    return meshlib.host_to_device(host, device), tet_cell


# ---------------------------------------------------------------------------
# field I/O
# ---------------------------------------------------------------------------


def read_field(path: str, n_cells: int | None = None) -> np.ndarray:
    """Read the internalField of a vol{Scalar,Vector}Field file.

    Handles ascii and ``format binary`` (raw little-endian scalars after
    the ``nonuniform List<T> N (`` token), plus ``.gz`` compressed files.
    """
    raw = _read_raw(path)
    hdr, _ = _parse_header_bytes(raw)
    if hdr.get("format") == "binary":
        m = re.search(
            rb"internalField\s+nonuniform\s+List<(\w+)>\s*(\d+)\s*\(", raw
        )
        if m:
            kind, count = m.group(1).decode(), int(m.group(2))
            _, scalar = _arch_sizes(hdr)
            ncol = 3 if kind == "vector" else 1
            nbytes = count * ncol * scalar.itemsize
            flat = np.frombuffer(
                raw[m.end() : m.end() + nbytes], dtype=scalar
            ).astype(np.float64)
            return flat.reshape(-1, 3) if kind == "vector" else flat
        # uniform internalField: ascii even in binary files — fall through
    text = _read_foam_body(path)
    m = re.search(r"internalField\s+uniform\s*(\(([^)]*)\)|[-+0-9.eE]+)\s*;", text)
    if m:
        if m.group(2) is not None:
            val = _nums(m.group(2))
        else:
            val = np.array([float(m.group(1))])
        if n_cells is not None:
            return np.tile(val, (n_cells, 1)) if len(val) > 1 else np.full(
                n_cells, val[0]
            )
        return val
    m = re.search(r"internalField\s+nonuniform\s+List<(\w+)>\s*(\d+)\s*\(", text)
    if not m:
        raise ValueError(f"no internalField found in {path}")
    kind, count = m.group(1), int(m.group(2))
    start = m.end()
    depth = 1
    i = start
    while depth > 0:
        c = text[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        i += 1
    inner = text[start : i - 1]
    nums = _nums(inner)
    if kind == "vector":
        out = nums.reshape(-1, 3)
    else:
        out = nums
    assert len(out) == count
    return out


def write_field(
    path: str,
    name: str,
    values: np.ndarray,
    dimensions=(0, 1, -1, 0, 0, 0, 0),
    boundary_field: dict | None = None,
    location: str | None = None,
    binary: bool = False,
    compress: bool = False,
):
    """Write a vol field file (internalField + boundaryField).

    ``binary`` writes the internalField payload as raw little-endian
    doubles (OpenFOAM ``writeFormat binary``); ``compress`` gzips the file
    to ``path + '.gz'`` (``writeCompression on``).  Both round-trip through
    :func:`read_field` / :func:`read_field_bcs`.
    """
    values = np.asarray(values)
    is_vector = values.ndim == 2
    cls = "volVectorField" if is_vector else "volScalarField"
    kind = "vector" if is_vector else "scalar"
    buf = []
    w = buf.append
    w(foamfile._HEADER.encode())
    w(b"FoamFile\n{\n    version 2.0;\n")
    w(f"    format {'binary' if binary else 'ascii'};\n".encode())
    if binary:
        w(b'    arch "LSB;label=32;scalar=64";\n')
    w(f"    class {cls};\n".encode())
    if location:
        w(f'    location "{location}";\n'.encode())
    w(f"    object {name};\n}}\n\n".encode())
    w(("dimensions [" + " ".join(str(d) for d in dimensions) + "];\n\n").encode())
    w(f"internalField nonuniform List<{kind}>\n{len(values)}\n(".encode())
    if binary:
        w(np.ascontiguousarray(values, dtype="<f8").tobytes())
    else:
        import io as _io

        txt = _io.StringIO()
        txt.write("\n")
        np.savetxt(
            txt, values,
            fmt="(%.10g %.10g %.10g)" if is_vector else "%.10g",
        )
        w(txt.getvalue().encode())
    w(b")\n;\n\nboundaryField\n{\n")
    for pname, spec in (boundary_field or {}).items():
        w(f"    {pname}\n    {{\n".encode())
        for k, v in spec.items():
            w(f"        {k} {v};\n".encode())
        w(b"    }\n")
    w(b"}\n")
    data = b"".join(buf)
    if compress:
        import gzip

        with gzip.open(path + ".gz", "wb") as fh:
            fh.write(data)
        if os.path.exists(path):
            os.remove(path)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def write_surface_field(
    path: str,
    name: str,
    internal: np.ndarray,
    boundary: dict,
    dimensions=(0, 3, -1, 0, 0, 0, 0),
    binary: bool = False,
    compress: bool = False,
):
    """Write a surfaceScalarField (e.g. ``phi``: internal-face values +
    per-patch boundary values) — what ``runTime.write()`` stores so
    restarts resume with the exact conservative flux."""
    internal = np.asarray(internal, dtype=np.float64)
    buf = []
    w = buf.append
    w(foamfile._HEADER.encode())
    w(b"FoamFile\n{\n    version 2.0;\n")
    w(f"    format {'binary' if binary else 'ascii'};\n".encode())
    if binary:
        w(b'    arch "LSB;label=32;scalar=64";\n')
    w(b"    class surfaceScalarField;\n")
    w(f"    object {name};\n}}\n\n".encode())
    w(("dimensions [" + " ".join(str(d) for d in dimensions) + "];\n\n").encode())

    def wlist(vals):
        w(f"nonuniform List<scalar>\n{len(vals)}\n(".encode())
        if binary:
            w(np.ascontiguousarray(vals, dtype="<f8").tobytes())
        else:
            w(("\n" + "\n".join(f"{v:.12g}" for v in vals) + "\n").encode())
        w(b")\n;\n")

    w(b"internalField   ")
    wlist(internal)
    w(b"\nboundaryField\n{\n")
    for pname, vals in boundary.items():
        w(f"    {pname}\n    {{\n        type calculated;\n"
          f"        value           ".encode())
        wlist(np.asarray(vals, dtype=np.float64))
        w(b"    }\n")
    w(b"}\n")
    data = b"".join(buf)
    if compress:
        import gzip

        with gzip.open(path + ".gz", "wb") as fh:
            fh.write(data)
        if os.path.exists(path):
            os.remove(path)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def read_surface_field(path: str, patches: list) -> np.ndarray | None:
    """Read a surfaceScalarField back into the [nf] face ordering
    (internal faces, then boundary faces in patch order).  ``patches``
    is the PolyMesh patch list; returns None when the file is absent."""
    if not (os.path.exists(path) or os.path.exists(path + ".gz")):
        return None
    raw = _read_raw(path)
    hdr, _ = _parse_header_bytes(raw)
    vals = []
    if hdr.get("format") == "binary":
        _, scalar = _arch_sizes(hdr)
        for m in re.finditer(rb"nonuniform\s+List<scalar>\s*(\d+)\s*\(", raw):
            count = int(m.group(1))
            vals.append(
                np.frombuffer(
                    raw[m.end() : m.end() + count * scalar.itemsize],
                    dtype=scalar,
                ).astype(np.float64)
            )
    else:
        text = _read_foam_body(path)
        for m in re.finditer(r"nonuniform\s+List<scalar>\s*(\d+)\s*\(([^)]*)\)",
                             text):
            v = _nums(m.group(2))
            assert len(v) == int(m.group(1))
            vals.append(v)
    if not vals:
        return None
    # first list = internal faces; the rest follow the boundaryField order,
    # which write_surface_field emits in patch order
    return np.concatenate(vals)


def _ascii_view(path: str) -> str:
    """Decoded file text with binary list payloads excised (so dict-level
    regex parsing works on ``format binary`` field files too)."""
    raw = _read_raw(path)
    hdr, _ = _parse_header_bytes(raw)
    if hdr.get("format") == "binary":
        _, scalar = _arch_sizes(hdr)
        out, pos = [], 0
        for m in re.finditer(rb"nonuniform\s+List<(\w+)>\s*(\d+)\s*\(", raw):
            kind, count = m.group(1).decode(), int(m.group(2))
            ncol = {"vector": 3, "tensor": 9, "symmTensor": 6}.get(kind, 1)
            end = m.end() + count * ncol * scalar.itemsize
            out.append(raw[pos : m.start()])
            out.append(b" nonuniform-elided ")
            pos = min(end + 1, len(raw))  # payload + closing ')'
        out.append(raw[pos:])
        raw = b"".join(out)
    text = foamfile.strip_comments(raw.decode("utf-8", errors="replace"))
    m = re.search(r"FoamFile\s*\{[^}]*\}", text)
    return text[m.end() :] if m else text


def read_field_bcs(path: str) -> dict:
    """Parse the boundaryField block of a field file into
    {patch: (type, value)} where value is a float / [3] list / None."""
    text = _ascii_view(path)
    m = re.search(r"boundaryField\s*\{", text)
    if not m:
        return {}
    # find matching closing brace
    depth, i = 1, m.end()
    while depth > 0 and i < len(text):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    body = text[m.end() : i - 1]
    out = {}
    for pm_ in re.finditer(r"([\"\w.\-]+)\s*\{([^{}]*)\}", body):
        name = pm_.group(1).strip('"')
        entries = dict(re.findall(r"(\w+)\s+([^;]+);", pm_.group(2)))
        btype = entries.get("type", "zeroGradient").strip()
        value = None
        if "value" in entries:
            v = entries["value"].strip()
            mv = re.match(r"uniform\s*\(([^)]*)\)", v)
            if mv:
                value = [float(x) for x in mv.group(1).split()]
            else:
                mv = re.match(r"uniform\s+([-+0-9.eE]+)", v)
                if mv:
                    value = float(mv.group(1))
        if "p0" in entries:
            # uniformTotalPressure with a p0 table: value = first entry;
            # full (t, p0) table appended for time-varying BCs
            nums = re.findall(
                r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?", entries["p0"]
            )
            if len(nums) >= 2:
                value = float(nums[1])
                table = [
                    (float(nums[i]), float(nums[i + 1]))
                    for i in range(0, len(nums) - 1, 2)
                ]
                out[name] = (btype, value, table)
                continue
        out[name] = (btype, value)
    return out


def read_cell_zones(mesh_dir: str) -> dict:
    """Parse constant/polyMesh/cellZones into {zone_name: label array}.

    Supports the ascii ``cellLabels List<label> N ( ... )`` form (binary
    payloads are excised like everywhere else via the count-sized read)."""
    path = os.path.join(mesh_dir, "cellZones")
    if not (os.path.exists(path) or os.path.exists(path + ".gz")):
        return {}
    raw = _read_raw(path)
    hdr, _ = _parse_header_bytes(raw)
    zones = {}
    if hdr.get("format") == "binary":
        label, _ = _arch_sizes(hdr)
        for m in re.finditer(
            rb"([\w.\-]+)\s*\{[^{}]*?cellLabels\s+List<label>\s*", raw
        ):
            vals, _ = _read_bin_list(raw, m.end(), label)
            zones[m.group(1).decode()] = vals.astype(np.int64)
        return zones
    text = _read_foam_body(path)
    for m in re.finditer(
        r"([\w.\-]+)\s*\{[^{}]*?cellLabels\s+List<label>\s*(\d+)\s*\(([^)]*)\)",
        text,
    ):
        labels = _nums(m.group(3), np.int64)
        assert len(labels) == int(m.group(2))
        zones[m.group(1)] = labels
    return zones


def latest_time_dir(case_dir: str) -> str | None:
    """Find the latest numeric time directory (``startFrom latestTime``)."""
    best, best_t = None, None
    for d in os.listdir(case_dir):
        full = os.path.join(case_dir, d)
        if not os.path.isdir(full):
            continue
        try:
            t = float(d)
        except ValueError:
            continue
        if best_t is None or t > best_t:
            best, best_t = d, t
    return best


# ---------------------------------------------------------------------------
# writing polyMesh
# ---------------------------------------------------------------------------


def write_polymesh(pm: PolyMesh, mesh_dir: str, binary: bool = False) -> None:
    """Write constant/polyMesh.  ``binary=True`` emits OpenFOAM
    ``format binary`` files (points/owner/neighbour as raw lists, faces
    as a ``faceCompactIOList`` offsets+flat pair) — what big production
    cases use; round-trips through the binary readers above."""
    os.makedirs(mesh_dir, exist_ok=True)
    fmt = "binary" if binary else "ascii"

    def header(obj, cls, note=None):
        h = foamfile._HEADER
        h += f"FoamFile\n{{\n    version 2.0;\n    format {fmt};\n"
        if binary:
            h += '    arch "LSB;label=32;scalar=64";\n'
        h += f"    class {cls};\n"
        if note:
            h += f'    note "{note}";\n'
        h += '    location "constant/polyMesh";\n'
        h += f"    object {obj};\n}}\n\n"
        return h

    def wbinlist(fh, arr, dtype):
        a = np.ascontiguousarray(arr, dtype=dtype)
        fh.write(f"{len(a)}\n(".encode())
        fh.write(a.tobytes())
        fh.write(b")\n")

    if binary:
        with open(os.path.join(mesh_dir, "points"), "wb") as fh:
            fh.write(header("points", "vectorField").encode())
            wbinlist(fh, np.asarray(pm.points).reshape(-1), "<f8")
        with open(os.path.join(mesh_dir, "faces"), "wb") as fh:
            fh.write(header("faces", "faceCompactIOList").encode())
            wbinlist(fh, pm.face_offsets, "<i4")
            wbinlist(fh, pm.face_verts, "<i4")
    else:
        with open(os.path.join(mesh_dir, "points"), "w") as fh:
            fh.write(header("points", "vectorField"))
            fh.write(f"{len(pm.points)}\n(\n")
            np.savetxt(fh, pm.points, fmt="(%.12g %.12g %.12g)")
            fh.write(")\n")
        with open(os.path.join(mesh_dir, "faces"), "w") as fh:
            fh.write(header("faces", "faceList"))
            fh.write(f"{pm.n_faces}\n(\n")
            sizes = np.diff(pm.face_offsets)
            for i in range(pm.n_faces):
                verts = pm.face(i)
                fh.write(f"{sizes[i]}(" + " ".join(map(str, verts)) + ")\n")
            fh.write(")\n")
    note = (
        f"nPoints:{len(pm.points)}  nCells:{pm.n_cells}  "
        f"nFaces:{pm.n_faces}  nInternalFaces:{pm.n_internal_faces}"
    )
    if binary:
        with open(os.path.join(mesh_dir, "owner"), "wb") as fh:
            fh.write(header("owner", "labelList", note).encode())
            wbinlist(fh, pm.owner, "<i4")
        with open(os.path.join(mesh_dir, "neighbour"), "wb") as fh:
            fh.write(header("neighbour", "labelList", note).encode())
            wbinlist(fh, pm.neighbour, "<i4")
    else:
        with open(os.path.join(mesh_dir, "owner"), "w") as fh:
            fh.write(header("owner", "labelList", note))
            fh.write(f"{len(pm.owner)}\n(\n")
            np.savetxt(fh, pm.owner, fmt="%d")
            fh.write(")\n")
        with open(os.path.join(mesh_dir, "neighbour"), "w") as fh:
            fh.write(header("neighbour", "labelList", note))
            fh.write(f"{len(pm.neighbour)}\n(\n")
            np.savetxt(fh, pm.neighbour, fmt="%d")
            fh.write(")\n")
    with open(os.path.join(mesh_dir, "boundary"), "w") as fh:
        fh.write(header("boundary", "polyBoundaryMesh"))
        fh.write(f"{len(pm.patches)}\n(\n")
        for name, ptype, start, cnt in pm.patches:
            fh.write(f"    {name}\n    {{\n")
            fh.write(f"        type            {ptype};\n")
            if ptype in ("wall",):
                fh.write("        inGroups        1(wall);\n")
            fh.write(f"        nFaces          {cnt};\n")
            fh.write(f"        startFace       {start};\n")
            fh.write("    }\n")
        fh.write(")\n")
    if pm.cell_zones:
        write_cell_zones(pm.cell_zones, mesh_dir)
