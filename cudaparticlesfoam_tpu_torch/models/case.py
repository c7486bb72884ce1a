"""Case loading shared by the solvers: mesh acquisition (polyMesh or
blockMesh regeneration), velocity snapshots, particle initialization.

Replaces the OpenFOAM case scaffolding the reference solvers inherit
(``createTime.H``/``createMesh.H``/``createFields.H``) plus the device-init
script ``src/initCuda.H``.

The port's copy of ``cudaparticlesfoam_tpu/models/case.py``: everything
takes an explicit ``device`` (default the card, ``dtypes.canonical_device``;
``"cpu"`` runs the kernels' plain versions).  The host-side build is the
JAX package's; its on-disk tet-mesh cache has a file name of its own
(:data:`CACHE_NAME`) and a fingerprint tag of its own, so neither package
ever reads the other's pickle.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import mesh as meshlib
from .. import state as statelib
from ..config import ControlConfig, ParticlesConfig
from ..dtypes import canonical_device, numpy_float
from ..io import blockmesh, polymesh
from ..ops import locate as locate_ops

CACHE_NAME = ".tetmesh_cache_torch.pkl"   # beside the JAX package's .tetmesh_cache.pkl


@dataclasses.dataclass
class Case:
    case_dir: str
    control: ControlConfig
    particles: ParticlesConfig
    poly: polymesh.PolyMesh
    tet_mesh: meshlib.TetMesh
    tet_cell: np.ndarray          # tet -> owning polyMesh cell
    locator: locate_ops.GridLocator
    time_value: float             # runTime.value() after startFrom
    time_dir: str                 # directory name of time_value ("0" cold)
    patch_names: list

    def update_velocity(self, u_cells: np.ndarray) -> None:
        """Refresh per-tet velocities from a cell field (the real version of
        the x12 replication at ``advect.H:44-55``)."""
        self.tet_mesh = meshlib.replace_velocity(
            self.tet_mesh, tet_vel=np.asarray(u_cells)[self.tet_cell]
        )


def time_dirs(case_dir: str) -> list[tuple[float, str]]:
    out = []
    for d in os.listdir(case_dir):
        full = os.path.join(case_dir, d)
        if not os.path.isdir(full):
            continue
        try:
            t = float(d)
        except ValueError:
            continue
        out.append((t, d))
    return sorted(out)


def read_u_snapshot(case_dir: str, time_dir: str, n_cells: int) -> np.ndarray | None:
    path = os.path.join(case_dir, time_dir, "U")
    if not os.path.exists(path):
        return None
    return polymesh.read_field(path, n_cells=n_cells)


def load_polymesh(case_dir: str, regenerate: bool = True, log=print) -> polymesh.PolyMesh:
    """Read constant/polyMesh if present, else regenerate from
    system/blockMeshDict (the tutorials' ``Allrun`` runs blockMesh first)."""
    mesh_dir = os.path.join(case_dir, "constant", "polyMesh")
    if os.path.exists(os.path.join(mesh_dir, "points")):
        log(f"#adv: reading polyMesh from {mesh_dir}")
        return polymesh.read_polymesh(mesh_dir)
    if not regenerate:
        raise FileNotFoundError(f"no polyMesh in {mesh_dir}")
    dict_path = os.path.join(case_dir, "system", "blockMeshDict")
    log(f"#adv: generating mesh from {dict_path}")
    return blockmesh.generate(dict_path)


# version of the host-side tet decomposition + table-build algorithm;
# part of the cache fingerprint (see _cached_tet_mesh)
_TET_CACHE_VERSION = 4


def _builder_flavor() -> str:
    """Which base-point builder is active: the OpenMP C++ kernel or the
    numpy fallback.  They agree except on exact quality TIES (regular
    cells), where last-ulp rounding picks different-but-equivalent bases
    — so the flavor must be part of the cache fingerprint."""
    from ..io import native

    return "native" if native._load("meshbuild") is not None else "numpy"


def _cached_tet_mesh(case_dir: str, poly, dtype, log, min_build_s: float = 10.0,
                     device=None):
    """Geometry-only tet mesh with an on-disk cache.

    The host-side table build (face dedup, walk tables, quality base
    points) is numpy and costs minutes at reference-coupled scale (2.98M
    tets); the result depends only on the polyMesh geometry, so it is
    pickled next to the case (``constant/polyMesh/`` :data:`CACHE_NAME`)
    keyed by a content fingerprint.  Velocities are applied by the caller.
    The mesh is uploaded to ``device`` once, from the host payload.
    """
    import hashlib
    import pickle

    fp = hashlib.sha1()
    # bump _TET_CACHE_VERSION on ANY change to the decomposition/table
    # build; "torch" keeps the fingerprint apart from the JAX package's
    fp.update(f"torch-v{_TET_CACHE_VERSION}-{_builder_flavor()}".encode())
    fp.update(np.ascontiguousarray(poly.points).tobytes())
    fp.update(np.ascontiguousarray(poly.owner).tobytes())
    fp.update(np.ascontiguousarray(poly.neighbour).tobytes())
    fp.update(np.ascontiguousarray(poly.face_offsets).tobytes())
    fp.update(np.ascontiguousarray(poly.face_verts).tobytes())
    fp.update(str(numpy_float(dtype)).encode())
    digest = fp.hexdigest()
    cache = os.path.join(case_dir, "constant", "polyMesh", CACHE_NAME)
    if os.path.exists(cache):
        try:
            with open(cache, "rb") as fh:
                payload = pickle.load(fh)
            if (
                payload.get("fingerprint") == digest
                and isinstance(payload.get("mesh_host"), dict)
            ):
                mesh = meshlib.host_to_device(payload["mesh_host"], device)
                log("#adv: tet mesh restored from cache")
                return mesh, payload["tet_cell"]
        except Exception as e:          # corrupt/stale cache: rebuild
            log(f"#adv: [warning] tet mesh cache unusable ({e}); rebuilding")
    t0 = time.perf_counter()
    host, tet_cell = polymesh.mesh_host_from_polymesh(poly, u_cells=None, dtype=dtype)
    build_s = time.perf_counter() - t0
    if build_s > min_build_s and os.path.isdir(os.path.dirname(cache)):
        try:
            with open(cache, "wb") as fh:
                pickle.dump({"fingerprint": digest, "mesh_host": host, "tet_cell": tet_cell},
                            fh)
            log(f"#adv: tet mesh cached ({build_s:.0f}s build)")
        except OSError as e:
            log(f"#adv: [warning] could not cache tet mesh: {e}")
    return meshlib.host_to_device(host, device), tet_cell


def load_case(case_dir: str, dtype=None, log=print, write_mesh: bool = False,
              device=None) -> Case:
    """The case of ``case_dir``: configs, polyMesh (or blockMesh), start
    time, the U snapshot at or before it, the tet mesh with that field on
    ``device`` (default the card) and its grid locator."""
    device = canonical_device(device)
    control = ControlConfig.from_case(case_dir)
    pcfg = ParticlesConfig.from_case(case_dir)
    poly = load_polymesh(case_dir, log=log)
    if write_mesh:
        polymesh.write_polymesh(poly, os.path.join(case_dir, "constant", "polyMesh"))

    # runTime start value
    tdirs = time_dirs(case_dir)
    if control.start_from == "latestTime" and tdirs:
        t0, t0_dir = tdirs[-1]
    elif control.start_from == "firstTime" and tdirs:
        t0, t0_dir = tdirs[0]
    else:
        t0 = control.start_time
        t0_dir = next((d for t, d in tdirs if abs(t - t0) < 1e-12), "0")

    # velocity field at start (MUST_READ in the reference, createFields.H:3-15)
    u = None
    for t, d in reversed(tdirs):
        if t <= t0 + 1e-12:
            u = read_u_snapshot(case_dir, d, poly.n_cells)
            if u is not None:
                break
    if u is None:
        log("#adv: [warning] no U snapshot found; using zero field")
        u = np.zeros((poly.n_cells, 3))

    wall = time.perf_counter()
    tet_mesh, tet_cell = _cached_tet_mesh(case_dir, poly, dtype, log, device=device)
    tet_mesh = meshlib.replace_velocity(tet_mesh, tet_vel=np.asarray(u)[tet_cell])
    if pcfg.escape_patches:
        names = [p[0] for p in poly.patches]
        ids = [names.index(nm) for nm in pcfg.escape_patches if nm in names]
        missing = [nm for nm in pcfg.escape_patches if nm not in names]
        if missing:
            log(f"#adv: [warning] escapePatches not found: {missing}")
        tet_mesh = meshlib.set_boundary_escape(tet_mesh, ids)
        log(f"#adv: absorbing patches: {[names[i] for i in ids]}")
    log(
        f"#adv: tet mesh: {tet_mesh.n_tets} tets, {tet_mesh.n_points} verts, "
        f"{tet_mesh.n_bd_faces} boundary tris "
        f"({(time.perf_counter()-wall)*1e3:.1f} ms)"
    )
    if pcfg.write_mesh_vtk:
        from ..io import vtu as vtu_io

        vtu_io.write_tet_mesh_vtk(os.path.join(case_dir, "mesh.vtk"), tet_mesh)
        vtu_io.write_face_mesh_vtk(os.path.join(case_dir, "mesh_faces.vtk"), tet_mesh)
        log("#adv: wrote mesh.vtk / mesh_faces.vtk")

    wall = time.perf_counter()
    locator = locate_ops.build_grid_locator(tet_mesh)
    # the analogue of '#adv BVH Construction Time' (initCuda.H:139)
    log(f"#adv: locator grid construction time={(time.perf_counter()-wall)*1e3:.3f} ms")

    return Case(
        case_dir=case_dir,
        control=control,
        particles=pcfg,
        poly=poly,
        tet_mesh=tet_mesh,
        tet_cell=tet_cell,
        locator=locator,
        time_value=t0,
        time_dir=t0_dir,
        patch_names=[p[0] for p in poly.patches],
    )


def init_particles(case: Case, log=print) -> statelib.ParticleState:
    """Seed + first locate + report (``initCuda.H:141-202``), on the case
    mesh's device and dtype."""
    p = case.particles
    dev, dt = case.tet_mesh.device, case.tet_mesh.dtype
    if p.seeding_file:
        st = statelib.seed_from_file(
            os.path.join(case.case_dir, p.seeding_file),
            n=p.num_particles, rng_seed=p.rng_seed, dtype=dt, device=dev,
        )
    else:
        st = statelib.seed_in_box(
            p.num_particles, p.seeding_box_lo, p.seeding_box_hi,
            rng_seed=p.rng_seed, method=p.seeding_method, dtype=dt, device=dev,
        )
    nbytes = sum(
        x.numel() * x.element_size() for x in (st.pos, st.vel, st.disp, st.tet_id, st.active)
    )
    log(f"#adv: particle mem: {nbytes/2**20:.1f}MB")
    # decide the path from at most ONE scalar readback, never the full id
    # array; box seeding never carries tet ids, so it needs none here
    n = st.pos.shape[0]
    if not p.seeding_file or not n:
        n_pre = 0
    else:
        n_pre = int((st.tet_id >= 0).sum())
    if n and n_pre == n:
        # seed file carried tetIDs: assign directly like cudaInitParticles
        # (particles.cu:150-156) — restart stays bit-identical, no re-locate
        tet = st.tet_id
    else:
        tet = locate_ops.locate_seeds(case.tet_mesh, case.locator, st.pos)
        if n_pre:
            tet = torch.where(st.tet_id >= 0, st.tet_id, tet)
    st = dataclasses.replace(st, tet_id=tet.to(torch.int32))
    n_bad = int((st.tet_id < 0).sum())
    log(f"#adv: Out-of-domain particles(-tetID) = {n_bad}")   # particles.cu:770
    return st
