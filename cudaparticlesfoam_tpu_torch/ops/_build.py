"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled at first use by its own ``nvcc`` process
(all started together), and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -std=c++17
         -Xcompiler -fPIC -lineinfo -Xptxas=-v -c -o <obj> csrc/<file>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

``--fmad=false`` (and no ``--use_fast_math``) keeps every kernel op for op
equal to its plain PyTorch version: no multiply-add contraction.  The
library lands in ``<repo>/build/torch_kernels/`` under a name that carries
a hash of the sources and flags, so an edited source or flag rebuilds.
ptxas's register and spill report of the last build is kept in
:func:`ptxas_report`.  There is no fallback: a missing ``nvcc`` or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
FLAGS = (ARCH, "-O3", "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
         "-lineinfo", "-Xptxas=-v")

_LIB: dict = {}          # loaded library (one per process) + build seconds


def find_nvcc() -> str:
    """Path of nvcc: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (searched $PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from csrc/*.cu at first use and "
        "need the CUDA toolkit"
    )


def sources(csrc: str = CSRC) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def _digest(csrc: str = CSRC) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def build(csrc: str = CSRC) -> str:
    """Compile the kernels of ``csrc`` (the package's own by default;
    another checkout's for an A/B measurement) if the hashed library is
    missing; returns its path.  One nvcc per source, run in parallel, then
    one link; every output goes to a temporary name first, so a cut build
    leaves nothing that looks finished."""
    digest = _digest(csrc)
    lib = os.path.join(BUILD_DIR, f"libcpf_kernels_{digest}.so")
    if os.path.exists(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    jobs = []
    for src in sources(csrc):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *FLAGS, "-I", csrc, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    report = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        report.append(out + err)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, ARCH, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    for _, obj, _ in jobs:
        os.remove(obj)
    os.replace(tmp, lib)
    _LIB[("ptxas", csrc)] = "".join(report)
    return lib


def ptxas_report(csrc: str = CSRC) -> str:
    """ptxas's ``-v`` lines (registers, stack, spills per kernel) of the
    build of ``csrc`` this process ran; empty when the library was already
    built."""
    return _LIB.get(("ptxas", csrc), "")


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call) with every entry
    point's argtypes/restype declared."""
    if "lib" in _LIB:
        return _LIB["lib"]
    t0 = time.perf_counter()
    lib = ctypes.CDLL(build())
    vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32
    key = [i, u, u, u, u]     # pass + 4 Philox key words
    for suffix, fl in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        for name, args in (
            # ..., noise mode, pass, the RK4 flag, the 4 key words, the stream
            ("stream", [vp] * 5 + [ll, fl, fl, i, i, i, i, i, i, i, i, u, u, u, u, vp]),
            ("stream_pk", [vp] * 5 + [ll, fl, fl, i, i, i, i, i, i, i, i, u, u, u, u, vp]),
            ("rare", [vp, vp, vp, vp, ll, i, i, i, i, vp]),
            ("rare_pk", [vp, vp, vp, vp, ll, i, i, i, i, vp]),
            # ..., R0 (boundary faces), per (tets a shard), the stream
            ("rare_remote", [vp, vp, vp, vp, ll, i, i, i, i, i, i, vp]),
            ("rare_remote_pk", [vp, vp, vp, vp, ll, i, i, i, i, i, i, vp]),
            ("convex_stream", [vp] * 6 + [ll, fl, fl, i, i, i, i, *key, vp]),
            ("convex_rare", [vp] * 11 + [ll, i, i, i, i, i, vp]),
            ("macro_stream", [vp] * 6 + [ll, i, fl, fl, i, i, i, i, i, *key, vp]),
            # tab, pos, its row stride, vel, its row stride, tet, active, m, n,
            # the mega's and the table's widths, the stream
            ("pack", [vp, vp, ll, vp, ll, vp, vp, vp, ll, i, i, vp]),
            # m, its width, pos, vel, tet, active, disp, n, the stream
            ("unpack", [vp, i, vp, vp, vp, vp, vp, ll, vp]),
        ):
            fn = getattr(lib, f"cpf_{name}_{suffix}")
            fn.argtypes = args
            fn.restype = i
    for suffix, fl in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        # n, the row plan (offsets, pos, col, nf), ..., the stream
        for name, args in (
            ("fv_matvec", [i, i, vp, vp, vp, i] + [vp] * 5 + [vp]),
            ("amg_down", [i, vp, vp, vp, vp, vp, i, vp, vp, vp, fl, vp, vp]),
            ("amg_up", [i, vp, vp, vp, i, vp, vp, vp, fl, vp, vp, vp, vp, vp]),
            # the tail: its TailParams (by address), threads a block,
            # shared memory a block (, the stream)
            ("amg_tail", [vp, i, i, vp]),
            ("amg_tail_prepare", [i, i, vp]),
        ):
            fn = getattr(lib, f"cpf_{name}_{suffix}")
            fn.argtypes = args
            fn.restype = i
    for name in ("rare_grid_f32", "rare_grid_f64", "rare_grid_pk_f32", "rare_grid_pk_f64",
                 "convex_rare_grid_f32", "convex_rare_grid_f64"):
        getattr(lib, f"cpf_{name}").argtypes = [ll]
        getattr(lib, f"cpf_{name}").restype = i
    lib.cpf_hop_admit.argtypes = [vp, vp, vp, ll, ll, vp]
    lib.cpf_hop_admit.restype = i
    lib.cpf_chase_nbr.argtypes = [vp, i, i, i, vp, vp]
    lib.cpf_chase_nbr.restype = i
    lib.cpf_chase_perm.argtypes = [vp, i, vp, vp]
    lib.cpf_chase_perm.restype = i
    lib.cpf_cluster_sync.argtypes = [i, i, i, i, vp, vp]
    lib.cpf_cluster_sync.restype = i
    lib.cpf_smem_chase.argtypes = [i, i, vp, vp]
    lib.cpf_smem_chase.restype = i
    lib.cpf_error_string.argtypes = [i]
    lib.cpf_error_string.restype = ctypes.c_char_p
    _LIB["lib"] = lib
    _LIB["seconds"] = time.perf_counter() - t0
    return lib


def build_seconds() -> float:
    """Seconds the first :func:`library` call took (build + load)."""
    library()
    return _LIB["seconds"]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err:
        msg = lib.cpf_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cuda error {err} ({msg})")
