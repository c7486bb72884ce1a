"""Particle / mesh / streamline writers.

Reproduces the reference's output surface (``cuda/utils.cpp``) so that
downstream ParaView pipelines built for cudaParticlesFoam keep working:

* ``write_particles_vtu``   — ``writeParticles2VTU`` (``utils.cpp:144-283``)
* ``write_particles_obj``   — ``writeParticles2OBJ`` (``utils.cpp:96-142``)
* ``Trajectories``          — ``addToTrajectories``/``saveTrajectories``/
                              ``writeStreamline2VTK`` (``utils.cpp:7-94``)
* ``write_tet_mesh_vtk`` / ``write_face_mesh_vtk`` — the mesh dumps the
  OptiX layer produces at BVH build (``optix/OptixTetQuery.cpp:331-417``)

``reference_quirks=True`` (default) replicates the reference's KEs field
bug byte-for-byte: ``utils.cpp:243-248`` writes 0.0 whenever KE is nonzero
(inverted truthiness), so the per-particle KEs column is effectively all
zeros while the *printed* system KE is real.  Set False for corrected
output.

The port's copy of ``cudaparticlesfoam_tpu/io/vtu.py``: the writers take a
state whose fields are torch tensors on any device (or numpy arrays) and
copy them to host numpy first (:func:`host`); the bytes written are the
JAX package's, on the native and on the pure-Python path
(``tests/test_torch_io.py``).
"""

from __future__ import annotations

import io as _io
import os

import numpy as np
import torch

from ..state import ParticleState


def host(x, dtype=None) -> np.ndarray:
    """``x`` (a torch tensor on any device, or an array-like) as host
    numpy, cast to ``dtype`` where given; a CUDA tensor is copied off the
    card (a synchronisation)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _fmt_block(fh, arr, fmt):
    np.savetxt(fh, arr, fmt=fmt)


def frame_path(path_or_step, out_dir: str = ".") -> str:
    """Resolve the reference's ``particle_%04d.vtu`` naming
    (``utils.cpp:177``) for int steps; pass explicit paths through."""
    if isinstance(path_or_step, (int, np.integer)):
        return os.path.join(out_dir, f"particle_{int(path_or_step):04d}.vtu")
    return str(path_or_step)


class AsyncVTUWriter:
    """Overlap VTU formatting/file IO with device compute.

    The reference writes synchronously every saveInterval cycles
    (``advect.H:163-175``); here the device->host copy happens on submit
    (it must), but the ascii formatting + file write run on one worker
    thread while the next fused chunk executes.  One frame in flight
    (submit drains the previous one), so ordering and bytes are identical
    to the synchronous writer.
    """

    def __init__(self):
        import concurrent.futures as cf

        self._ex = cf.ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def write(self, path_or_step, state, out_dir: str = ".", **kw) -> str:
        import types

        # the frame is copied to host numpy BEFORE the worker gets it: the
        # caller's next chunk of cycles may reuse the memory the state
        # points into (a CPU tensor's numpy view would share it)
        def snap(x):
            return np.array(host(x), copy=True)

        held = types.SimpleNamespace(
            pos=snap(state.pos),
            vel=snap(state.vel),
            tet_id=snap(state.tet_id),
            active=snap(state.active),
        )
        if kw.get("convex_tet_id") is not None:
            kw["convex_tet_id"] = snap(kw["convex_tet_id"])
        self.drain()
        os.makedirs(out_dir, exist_ok=True)
        self._pending = self._ex.submit(
            write_particles_vtu, path_or_step, held, out_dir=out_dir, **kw
        )
        return frame_path(path_or_step, out_dir)

    def drain(self):
        if self._pending is not None:
            path = self._pending.result()
            self._pending = None
            return path
        return None

    def close(self):
        self.drain()
        self._ex.shutdown()


def write_particles_vtu(
    path_or_step,
    state: ParticleState,
    convex_tet_id=None,
    reference_quirks: bool = True,
    out_dir: str = ".",
    verbose: bool = False,
) -> str:
    """Write one VTU frame.

    ``path_or_step``: either an explicit path or an int step index, in which
    case the reference's ``particle_%04d.vtu`` naming is used
    (``utils.cpp:177``).  Returns the written path and the system KE via
    attribute on the function result? No — returns path; use
    :func:`system_kinetic_energy` for the diagnostic.
    """
    os.makedirs(out_dir, exist_ok=True)
    path = frame_path(path_or_step, out_dir)

    pos = host(state.pos, np.float64)
    vel = host(state.vel, np.float64)
    tet = host(state.tet_id, np.int64)
    active = host(state.active).astype(np.int64)
    n = len(pos)
    ids = np.arange(n, dtype=np.int64)

    # native fast path (csrc/fastio.cpp); byte-identical to the text below
    from . import native

    if convex_tet_id is None and native.write_particles_vtu(
        path, pos, vel, tet, active, ke_quirk=reference_quirks
    ):
        if verbose:
            ke_all = 0.5 * np.sum(vel * vel, axis=-1)
            total_ke = float(np.nansum(ke_all))
            print(f"#adv: Write particles to file {path}...")
            print(f"#adv: System Kinetic Energy={total_ke:f}")
            if np.isnan(ke_all).any():
                # the reference aborts here (utils.cpp:253-256); we warn
                print("#adv: [warning] NaN particle kinetic energy detected")
        return path

    buf = _io.StringIO()
    w = buf.write
    w(
        "<VTKFile type='UnstructuredGrid' version='1.0' "
        "byte_order='LittleEndian' header_type='UInt64'>\n"
    )
    w("<UnstructuredGrid>\n")
    w(f"<Piece NumberOfCells='{n}' NumberOfPoints='{n}'>\n")
    w("<Points>\n")
    w("<DataArray NumberOfComponents='3' type='Float64' Name='Position' format='ascii'>\n")
    _fmt_block(buf, pos, "%.15f %.15f %.15f")
    w("</DataArray>\n</Points>\n<PointData>\n")
    w("<DataArray NumberOfComponents='1' type='Int32' Name='ParticleType' format='ascii'>\n")
    _fmt_block(buf, active, "%d")
    w("</DataArray>\n")
    w("<DataArray NumberOfComponents='1' type='Int32' Name='ParticleID' format='ascii'>\n")
    _fmt_block(buf, ids, "%d")
    w("</DataArray>\n")
    w("<DataArray NumberOfComponents='1' type='Int32' Name='ParticleTetID' format='ascii'>\n")
    _fmt_block(buf, tet, "%d")
    if convex_tet_id is not None:
        ctet = host(convex_tet_id, np.int64)
        w("</DataArray>\n")
        w("<DataArray NumberOfComponents='1' type='Int32' Name='ConvexTetID' format='ascii'>\n")
        _fmt_block(buf, ctet, "%d")
    w("</DataArray>\n")
    w("<DataArray NumberOfComponents='3' type='Float32' Name='vels' format='ascii'>\n")
    vel_out = np.where(np.isnan(vel[:, :1]), 0.0, vel)  # NaN row -> zeros
    _fmt_block(buf, vel_out, "%f %f %f")
    w("</DataArray>\n")
    w("<DataArray NumberOfComponents='1' type='Float32' Name='KEs' format='ascii'>\n")
    ke = 0.5 * np.sum(vel * vel, axis=-1)
    if reference_quirks:
        # utils.cpp:243-248: `if (KE) print 0.0 else print KE` — inverted
        ke_out = np.where(ke != 0.0, 0.0, ke)
    else:
        ke_out = ke
    _fmt_block(buf, ke_out, "%f")
    w("</DataArray>\n</PointData>\n<Cells>\n")
    w("<DataArray type='Int32' Name='connectivity' format='ascii'>\n")
    _fmt_block(buf, ids, "%d")
    w("</DataArray>\n")
    w("<DataArray type='Int32' Name='offsets' format='ascii'>\n")
    _fmt_block(buf, ids + 1, "%d")
    w("</DataArray>\n")
    w("<DataArray type='UInt8' Name='types' format='ascii'>\n")
    _fmt_block(buf, np.ones(n, dtype=np.int64), "%d")
    w("</DataArray>\n</Cells>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")

    with open(path, "w") as fh:
        fh.write(buf.getvalue())
    if verbose:
        total_ke = float(np.nansum(ke))
        print(f"#adv: Write particles to file {path}...")
        print(f"#adv: System Kinetic Energy={total_ke:f}")
        if np.isnan(ke).any():
            # the reference aborts here (utils.cpp:253-256); we warn
            print("#adv: [warning] NaN particle kinetic energy detected")
    return path


def system_kinetic_energy(state: ParticleState, mass: float = 1.0) -> float:
    vel = host(state.vel, np.float64)
    return float(0.5 * mass * np.sum(vel * vel))


def write_particles_obj(path_or_step, state: ParticleState, out_dir: str = ".") -> str:
    """OBJ point dump (``writeParticles2OBJ``, ``utils.cpp:96-142``)."""
    if isinstance(path_or_step, (int, np.integer)):
        path = os.path.join(out_dir, f"particle_{int(path_or_step):04d}.obj")
    else:
        path = str(path_or_step)
    pos = host(state.pos, np.float64)
    with open(path, "w") as fh:
        np.savetxt(fh, pos, fmt="v %.15f %.15f %.15f")
    return path


class Trajectories:
    """Streamline accumulation + writers (``utils.cpp:7-94``).

    Appends active-particle positions per sampled step; writes OBJ polylines
    (``saveTrajectories``) and legacy-VTK polydata with StreamlineID cell
    data (``writeStreamline2VTK``).
    """

    def __init__(self, n_particles: int):
        self.tracks: list[list[np.ndarray]] = [[] for _ in range(n_particles)]

    def append(self, state: ParticleState) -> None:
        pos = host(state.pos, np.float32)
        act = host(state.active)
        for i in np.nonzero(act)[0]:
            self.tracks[i].append(pos[i])

    def save_obj(self, path: str) -> None:
        with open(path, "w") as fh:
            nv = 0
            for tr in self.tracks:
                if len(tr) <= 1:
                    continue
                first = nv + 1
                for p in tr:
                    fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
                    nv += 1
                for i in range(len(tr) - 1):
                    fh.write(f"l {first + i} {first + i + 1}\n")

    def save_vtk(self, path: str) -> None:
        lines = [tr for tr in self.tracks if len(tr) > 1]
        nv = sum(len(tr) for tr in lines)
        with open(path, "w") as fh:
            fh.write("# vtk DataFile Version 4.1\nvtk output\nASCII\nDATASET POLYDATA\n")
            fh.write(f"POINTS {nv} float\n")
            for tr in lines:
                for p in tr:
                    fh.write(f"{p[0]} {p[1]} {p[2]}\n")
            fh.write("\n")
            fh.write(f"LINES {len(lines)} {nv + len(lines)}\n")
            vid = 0
            for tr in lines:
                fh.write(str(len(tr)))
                for _ in tr:
                    fh.write(f" {vid}")
                    vid += 1
                fh.write("\n")
            fh.write("\n\n")
            fh.write(f"CELL_DATA {len(lines)}\n")
            fh.write("FIELD FieldData 1\n")
            fh.write(f"StreamlineID 1 {len(lines)} int\n")
            for i in range(len(lines)):
                fh.write(f"{i} \n")


def write_tet_mesh_vtk(path: str, mesh) -> None:
    """Legacy-VTK dump of the volume tet mesh (cf. ``mesh.vtk`` at
    ``OptixTetQuery.cpp:374-417``)."""
    pts = mesh.host["points"].astype(np.float64)
    tets = mesh.host["tets"].astype(np.int64)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 4.1\nvtk output\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {len(pts)} double\n")
        np.savetxt(fh, pts, fmt="%.15g %.15g %.15g")
        fh.write(f"\nCELLS {len(tets)} {len(tets) * 5}\n")
        np.savetxt(
            fh,
            np.hstack([np.full((len(tets), 1), 4, dtype=np.int64), tets]),
            fmt="%d",
        )
        fh.write(f"\nCELL_TYPES {len(tets)}\n")
        np.savetxt(fh, np.full(len(tets), 10, dtype=np.int64), fmt="%d")


def write_face_mesh_vtk(path: str, mesh, boundary_only: bool = True) -> None:
    """Legacy-VTK dump of faces (cf. ``mesh_faces.vtk``,
    ``OptixTetQuery.cpp:331-372``); boundary_only gives the surface mesh."""
    pts = mesh.host["points"].astype(np.float64)
    tris = mesh.host["bd_tris" if boundary_only else "faces"].astype(np.int64)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 4.1\nvtk output\nASCII\nDATASET POLYDATA\n")
        fh.write(f"POINTS {len(pts)} double\n")
        np.savetxt(fh, pts, fmt="%.15g %.15g %.15g")
        fh.write(f"\nPOLYGONS {len(tris)} {len(tris) * 4}\n")
        np.savetxt(
            fh,
            np.hstack([np.full((len(tris), 1), 3, dtype=np.int64), tris]),
            fmt="%d",
        )
