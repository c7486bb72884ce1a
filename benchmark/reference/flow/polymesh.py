"""OpenFOAM polyMesh and field readers and the mesh geometry, for the flow
reference: a frozen copy of the port's numpy paths (``io/polymesh.py``):
faces' and cells' centres, areas and volumes by OpenFOAM's algorithms, the
internal fields and the boundary conditions of a case's ``0/`` files.
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


def face_centres_areas(pm: PolyMesh):
    """Face centroids and area vectors, OpenFOAM algorithm
    (primitiveMeshFaceCentresAndAreas): triangle-fan around the estimated
    centre with area weighting; exact centroid for triangles."""
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

