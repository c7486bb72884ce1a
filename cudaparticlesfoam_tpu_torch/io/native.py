"""ctypes loader for the native host runtime (the repo's ``csrc/fastio.cpp``
and ``csrc/meshbuild.cpp``), the port's copy of
``cudaparticlesfoam_tpu/io/native.py``.

Both sources sit at the repo root, beside the two packages.  The port
compiles them at first use with ``g++`` and the JAX package's flags into
``<repo>/build/torch_native/`` under names that carry a hash of the source
and flags, never next to the JAX package's libraries; a build goes to a
temporary name first, so concurrent processes never load a half-written
library.  Without ``g++`` (or without the sources, as in an installed
wheel) every entry returns ``None`` / ``False`` and the callers run their
numpy and pure-Python paths, as in the JAX package.  This is host code:
nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_REPO, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
# the JAX package's flags (cudaparticlesfoam_tpu/io/native.py), per library
FLAGS = {
    "fastio": ("-O3", "-shared", "-fPIC"),
    "meshbuild": ("-O3", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC"),
}
_libs: dict = {}         # name -> loaded CDLL, or None after a failed attempt


def _compile(name: str):
    """Path of ``lib<name>_<hash>.so`` built from ``csrc/<name>.cpp``
    (compiled if missing); raises where that cannot be done."""
    src = os.path.join(CSRC, f"{name}.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(" ".join(FLAGS[name]).encode() + fh.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        subprocess.run(["g++", *FLAGS[name], src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load(name: str):
    """The loaded library ``name``, or None where it cannot be built."""
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(_compile(name))
        except Exception:
            lib = None
        else:
            (_declare_fastio if name == "fastio" else _declare_meshbuild)(lib)
        _libs[name] = lib
        return lib


def _declare_fastio(lib):
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.parse_doubles.restype = ctypes.c_long
    lib.parse_doubles.argtypes = [ctypes.c_char_p, ctypes.c_long, f64, ctypes.c_long]
    lib.parse_longs.restype = ctypes.c_long
    lib.parse_longs.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_long]
    lib.write_particles_vtu.restype = ctypes.c_int
    lib.write_particles_vtu.argtypes = [
        ctypes.c_char_p, f64, f64, i32, i32,
        ctypes.c_void_p,            # convex ids or NULL
        ctypes.c_long, ctypes.c_int,
    ]
    lib.write_particles_obj.restype = ctypes.c_int
    lib.write_particles_obj.argtypes = [ctypes.c_char_p, f64, ctypes.c_long]


def _declare_meshbuild(lib):
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.face_base_points.restype = None
    lib.face_base_points.argtypes = [f64, i64, i64, i64, i64, f64,
                                     ctypes.c_int64, ctypes.c_int64, i64]
    lib.face_centres_areas.restype = None
    lib.face_centres_areas.argtypes = [f64, i64, i64, ctypes.c_int64, f64, f64]
    lib.build_tet_tables.restype = None
    lib.build_tet_tables.argtypes = [
        f64, i64, ctypes.c_int64, ctypes.c_int64,
        i32, i32, i32, i32, i32, i32, i32,
        f64, f64, i32, f64, f64, i64,
    ]


def _parse(text: str, dtype, entry):
    raw = text.encode()
    # numbers are >= 2 chars apart on average in these files, so
    # cap = len/2 + 2 suffices; re-run with the exact size if not
    cap = len(raw) // 2 + 2
    out = np.empty(cap, dtype)
    n = entry(raw, len(raw), out, cap)
    if n > cap:
        out = np.empty(n, dtype)
        n = entry(raw, len(raw), out, n)
    return out[:n].copy()


def available() -> bool:
    """Whether the parsing library (``csrc/fastio.cpp``) builds and loads
    here (JAX ``native.available``)."""
    return _load("fastio") is not None


def parse_doubles(text: str) -> np.ndarray | None:
    lib = _load("fastio")
    return None if lib is None else _parse(text, np.float64, lib.parse_doubles)


def parse_longs(text: str) -> np.ndarray | None:
    lib = _load("fastio")
    return None if lib is None else _parse(text, np.int64, lib.parse_longs)


def write_particles_vtu(path: str, pos, vel, tet_ids, types, convex_ids=None,
                        ke_quirk=True) -> bool:
    lib = _load("fastio")
    if lib is None:
        return False
    pos = np.ascontiguousarray(pos, np.float64)
    vel = np.ascontiguousarray(vel, np.float64)
    tet_ids = np.ascontiguousarray(tet_ids, np.int32)
    types = np.ascontiguousarray(types, np.int32)
    cptr = None
    if convex_ids is not None:
        convex_ids = np.ascontiguousarray(convex_ids, np.int32)
        cptr = convex_ids.ctypes.data_as(ctypes.c_void_p)
    rc = lib.write_particles_vtu(path.encode(), pos, vel, tet_ids, types, cptr, len(pos),
                                 int(ke_quirk))
    return rc == 0


def write_particles_obj(path: str, pos) -> bool:
    lib = _load("fastio")
    if lib is None:
        return False
    pos = np.ascontiguousarray(pos, np.float64)
    return lib.write_particles_obj(path.encode(), pos, len(pos)) == 0


# ---------------------------------------------------------------------------
# native mesh builders (csrc/meshbuild.cpp, OpenMP)
# ---------------------------------------------------------------------------


def face_base_points(points, face_verts, face_offsets, owner, neighbour,
                     n_int, cell_ctrs) -> "np.ndarray | None":
    """OpenMP quality-driven base-point search; None if no toolchain
    (caller falls back to the numpy implementation)."""
    lib = _load("meshbuild")
    if lib is None:
        return None
    points = np.ascontiguousarray(points, np.float64)
    face_verts = np.ascontiguousarray(face_verts, np.int64)
    face_offsets = np.ascontiguousarray(face_offsets, np.int64)
    owner = np.ascontiguousarray(owner, np.int64)
    neighbour = np.ascontiguousarray(neighbour, np.int64)
    cell_ctrs = np.ascontiguousarray(cell_ctrs, np.float64)
    nf = len(face_offsets) - 1
    out = np.empty(nf, np.int64)
    lib.face_base_points(points, face_verts, face_offsets, owner, neighbour, cell_ctrs,
                         nf, int(n_int), out)
    return out


def face_centres_areas(points, face_verts, face_offsets):
    """OpenMP face centroids + area vectors; None if no toolchain."""
    lib = _load("meshbuild")
    if lib is None:
        return None
    points = np.ascontiguousarray(points, np.float64)
    face_verts = np.ascontiguousarray(face_verts, np.int64)
    face_offsets = np.ascontiguousarray(face_offsets, np.int64)
    nf = len(face_offsets) - 1
    ctrs = np.empty((nf, 3), np.float64)
    areas = np.empty((nf, 3), np.float64)
    lib.face_centres_areas(points, face_verts, face_offsets, nf, ctrs, areas)
    return ctrs, areas


def build_tet_tables(points, tets):
    """OpenMP C++ canonicalize + face tables + walk table (bit-faithful to
    the numpy builders, see csrc/meshbuild.cpp); None if no toolchain.

    Returns (tets_canon, faces, tet_faces, face_front, face_back,
    bd_face_ids, bd_tet, bd_slot, a, tinv, nbr, n, dpl).
    """
    lib = _load("meshbuild")
    if lib is None:
        return None
    points = np.ascontiguousarray(points, np.float64)
    tets = np.ascontiguousarray(tets, np.int64).copy()   # canonicalized in place
    nt = len(tets)
    m4 = 4 * nt
    faces = np.empty((m4, 3), np.int32)
    tet_faces = np.empty((nt, 4), np.int32)
    face_front = np.empty(m4, np.int32)
    face_back = np.empty(m4, np.int32)
    bd_ids = np.empty(m4, np.int32)
    bd_tet = np.empty(m4, np.int32)
    bd_slot = np.empty(m4, np.int32)
    a = np.empty((nt, 3), np.float64)
    tinv = np.empty((nt, 3, 3), np.float64)
    nbr = np.empty((nt, 4), np.int32)
    n = np.empty((nt, 4, 3), np.float64)
    dpl = np.empty((nt, 4), np.float64)
    counts = np.zeros(2, np.int64)
    lib.build_tet_tables(points, tets, nt, len(points),
                         faces, tet_faces, face_front, face_back, bd_ids, bd_tet, bd_slot,
                         a, tinv, nbr, n, dpl, counts)
    nf, nbd = int(counts[0]), int(counts[1])
    return (
        tets, faces[:nf].copy(), tet_faces, face_front[:nf].copy(),
        face_back[:nf].copy(), bd_ids[:nbd].copy(), bd_tet[:nbd].copy(),
        bd_slot[:nbd].copy(), a, tinv, nbr, n, dpl,
    )
