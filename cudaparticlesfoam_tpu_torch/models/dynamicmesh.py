"""Dynamic (moving) mesh: solid-body + per-cellZone motion, ALE fluxes.

The port of ``cudaparticlesfoam_tpu/models/dynamicmesh.py``: the
moving-mesh branch of the coupled solver (``cudaParticlesPimpleFoam.C:144-170``:
``mesh.controlledUpdate()``, ``correctPhi``, ``fvc::makeRelative``) for the
OpenFOAM ``solidBodyMotionFvMesh`` / ``dynamicMotionSolverFvMesh + solidBody``
configurations (rigid whole-domain motion) and
``multiSolidBodyMotionFvMesh`` / ``multiSolidBody`` (per-cellZone rigid
motion with the connecting cells deforming), with the standard
``solidBodyMotionFunction``s (linearMotion, rotatingMotion,
oscillatingLinearMotion, oscillatingRotatingMotion), and the Laplacian
motion solvers of :mod:`.motionsolver`.  Topology changes are out of scope.

The split of the work:
* point motion + FV metric rebuild: host numpy once per Eulerian step
  (topology never changes), uploaded to the solver's device;
* the particle walk tables refresh on the device
  (:func:`~cudaparticlesfoam_tpu_torch.mesh.refresh_geometry`), since tet
  topology and neighbour codes are motion-invariant;
* mesh flux (``meshPhi``) from the midpoint face sweep
  ``((Cf_new - Cf_old)/dt) . (Sf_new + Sf_old)/2`` — exact for rigid
  translation, second order for rotation; convective fluxes are made
  relative (``fvc::makeRelative(phi, U)``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..dtypes import canonical_device
from ..io import foamfile
from . import fv


@dataclasses.dataclass(frozen=True)
class SolidBodyMotion:
    """One solidBodyMotionFunction: rigid transform of the initial points."""

    kind: str                  # linearMotion | rotatingMotion | oscillating*
    origin: tuple = (0.0, 0.0, 0.0)
    axis: tuple = (0.0, 0.0, 1.0)
    omega: float = 0.0         # rad/s (rotatingMotion / oscillating* angular)
    velocity: tuple = (0.0, 0.0, 0.0)   # linearMotion
    amplitude: tuple = (0.0, 0.0, 0.0)  # oscillatingLinearMotion (m) or
    #                                     oscillatingRotatingMotion (degrees)

    def transform(self, points0: np.ndarray, t: float) -> np.ndarray:
        """Points at time t from the t=0 configuration."""
        p = np.asarray(points0, dtype=np.float64)
        if self.kind == "linearMotion":
            return p + np.asarray(self.velocity) * t
        if self.kind == "oscillatingLinearMotion":
            return p + np.asarray(self.amplitude) * math.sin(self.omega * t)
        if self.kind in ("rotatingMotion", "oscillatingRotatingMotion"):
            if self.kind == "rotatingMotion":
                theta = self.omega * t
                ax = np.asarray(self.axis, dtype=np.float64)
                ax = ax / max(np.linalg.norm(ax), 1e-300)
                rot = _rodrigues(ax, theta)
            else:
                # amplitude is a degrees VECTOR (axis-angle per component)
                ang = np.deg2rad(np.asarray(self.amplitude)) * math.sin(self.omega * t)
                mag = np.linalg.norm(ang)
                ax = ang / mag if mag > 0 else np.array([0.0, 0.0, 1.0])
                rot = _rodrigues(ax, mag)
            o = np.asarray(self.origin, dtype=np.float64)
            return (p - o) @ rot.T + o
        raise ValueError(f"unsupported solidBodyMotionFunction {self.kind!r}")


def _rodrigues(axis: np.ndarray, theta: float) -> np.ndarray:
    k = np.asarray(axis, dtype=np.float64)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)


def _fn1_value(v):
    """Function1 scalar: `constant X` tokens or a bare number."""
    if isinstance(v, list):
        nums = [x for x in v if isinstance(x, (int, float))]
        return float(nums[0]) if nums else 0.0
    return float(v)


def _vec(v, default=(0.0, 0.0, 0.0)):
    if isinstance(v, list) and len(v) == 3:
        return tuple(float(x) for x in v)
    return default


@dataclasses.dataclass(frozen=True)
class MultiSolidBodyMotion:
    """Per-cellZone rigid motion (OpenFOAM ``multiSolidBodyMotionFvMesh`` /
    ``multiSolidBody`` motion solver): each named cellZone's points move
    with its own solidBodyMotionFunction; cells between zones deform."""

    zones: tuple     # ((zone_name, SolidBodyMotion), ...)
    kind: str = "multiSolidBody"


def _solid_body_from(fn: str, coeffs: dict) -> SolidBodyMotion:
    return SolidBodyMotion(
        kind=fn,
        origin=_vec(coeffs.get("origin")),
        axis=_vec(coeffs.get("axis"), (0.0, 0.0, 1.0)),
        omega=_fn1_value(coeffs.get("omega", 0.0)),
        velocity=_vec(coeffs.get("velocity")),
        amplitude=_vec(coeffs.get("amplitude")),
    )


def read_dynamic_mesh(case_dir: str):
    """Parse constant/dynamicMeshDict; None for static/absent meshes.
    Returns a SolidBodyMotion (whole domain), a MultiSolidBodyMotion
    (per-cellZone) or a :class:`.motionsolver.MotionSolverMotion`."""
    path = os.path.join(case_dir, "constant", "dynamicMeshDict")
    if not os.path.exists(path):
        return None
    d = foamfile.read(path)
    d.pop("FoamFile", None)
    fvmesh = str(d.get("dynamicFvMesh", "staticFvMesh"))
    if fvmesh == "staticFvMesh":
        return None

    def zone_dicts(sub):
        """{zone: {solidBodyMotionFunction ...; <fn>Coeffs {...}}} form."""
        zones = []
        for zname, zd in sub.items():
            if not isinstance(zd, dict) or "solidBodyMotionFunction" not in zd:
                continue
            zfn = str(zd["solidBodyMotionFunction"])
            zones.append((str(zname), _solid_body_from(zfn, zd.get(f"{zfn}Coeffs", {}))))
        return zones

    # multiSolidBodyMotionFvMesh / motionSolver multiSolidBody forms
    multi_sub = None
    if fvmesh == "multiSolidBodyMotionFvMesh":
        multi_sub = d.get("multiSolidBodyMotionFvMeshCoeffs", {})
    elif str(d.get("motionSolver", d.get("solver", ""))) == "multiSolidBody":
        multi_sub = d.get("multiSolidBodyCoeffs", d)
    if multi_sub is not None:
        zones = zone_dicts(multi_sub)
        if not zones:
            raise ValueError("multiSolidBody dynamicMeshDict with no zone motion entries")
        return MultiSolidBodyMotion(zones=tuple(zones))

    fn = d.get("solidBodyMotionFunction")
    coeffs = {}
    if fn is None and ("motionSolverLibs" in d or "motionSolver" in d):
        # dynamicMotionSolverFvMesh form: solver solidBody; + nested coeffs
        fn = d.get("solidBody", {}).get("solidBodyMotionFunction")
        coeffs = d.get("solidBody", {})
    fn = str(fn) if fn is not None else None
    if fn is None:
        # Laplacian-smoothed motion solvers (deforming mesh)
        from . import motionsolver as ms

        motion = ms.parse_motion_solver(d, case_dir)
        if motion is not None:
            return motion
        raise ValueError(
            f"dynamicMeshDict: unsupported configuration {fvmesh!r} (solid-body, "
            "multiSolidBody, and the Laplacian motion solvers velocityLaplacian/"
            "displacementLaplacian/velocityComponentLaplacian are implemented)")
    coeffs = d.get(f"{fn}Coeffs", coeffs.get(f"{fn}Coeffs", {}))
    return _solid_body_from(fn, coeffs)


def _zone_point_ids(pm, cells: np.ndarray) -> np.ndarray:
    """Point ids belonging to the given cells (points of every face whose
    owner or neighbour is in the set — the zone's pointZone)."""
    inz = np.zeros(pm.n_cells, bool)
    inz[np.asarray(cells, np.int64)] = True
    sizes = np.diff(pm.face_offsets)
    face_in = inz[pm.owner].copy()
    face_in[: pm.n_internal_faces] |= inz[pm.neighbour]
    mask = np.repeat(face_in, sizes)
    return np.unique(np.asarray(pm.face_verts)[mask])


class DynamicMesh:
    """Per-step mesh motion driver (``mesh.controlledUpdate()``); the FV
    meshes it returns live on ``device`` (default the card) in ``dtype``
    (default float32)."""

    def __init__(self, motion, pm, dtype=None, device=None):
        self.motion = motion
        self.pm = pm
        self.points0 = np.asarray(pm.points, dtype=np.float64).copy()
        self.dtype = dtype
        self.device = canonical_device(device)
        self._cf_old = None
        self._zone_pts = None
        self._lap = None
        from . import motionsolver as ms

        if isinstance(motion, ms.MotionSolverMotion):
            self._lap = ms.LaplacianMotion(motion, pm, dtype=dtype, device=self.device)
        elif isinstance(motion, MultiSolidBodyMotion):
            zones = pm.cell_zones or {}
            missing = [z for z, _ in motion.zones if z not in zones]
            if missing:
                raise ValueError(
                    f"dynamicMeshDict references cellZones {missing} not present in the mesh "
                    "(constant/polyMesh/cellZones or named blockMeshDict blocks)")
            self._zone_pts = {z: _zone_point_ids(pm, zones[z]) for z, _ in motion.zones}

    def _points_at(self, t: float) -> np.ndarray:
        if self._zone_pts is not None:
            pts = self.points0.copy()
            for name, sb in self.motion.zones:
                ids = self._zone_pts[name]
                pts[ids] = sb.transform(self.points0[ids], t)
            return pts
        return self.motion.transform(self.points0, t)

    def _fv(self):
        return fv.fv_mesh(self.pm, dtype=self.dtype, device=self.device)

    def update(self, t_new: float, dt: float):
        """Move points to t_new; returns (FvMesh, meshPhi[nf], bd_vel[nbd,3]).

        meshPhi is the swept face flux (midpoint rule); bd_vel the velocity
        of the boundary face centres (movingWallVelocity values)."""
        if self._lap is not None:
            if self._cf_old is None:
                # first step: old metrics = the pre-motion geometry
                m_old = self._fv()
                self._cf_old = (fv.host(m_old.cf).astype(np.float64),
                                fv.host(m_old.sf).astype(np.float64))
            pts = self._lap.points_at(t_new, dt)
        else:
            pts = self._points_at(t_new)
        self.pm.points = pts
        m_new = self._fv()
        cf_new = fv.host(m_new.cf).astype(np.float64)
        if self._cf_old is None:
            # first step: derive old face centres by transforming backwards
            pm_pts = self.pm.points
            self.pm.points = self._points_at(t_new - dt)
            m_old = self._fv()
            self.pm.points = pm_pts
            cf_old = fv.host(m_old.cf).astype(np.float64)
            sf_old = fv.host(m_old.sf).astype(np.float64)
        else:
            cf_old, sf_old = self._cf_old
        sf_new = fv.host(m_new.sf).astype(np.float64)
        v_face = (cf_new - cf_old) / dt
        mesh_phi = np.einsum("ij,ij->i", v_face, 0.5 * (sf_new + sf_old))
        self._cf_old = (cf_new, sf_new)
        bd_vel = v_face[m_new.n_internal:]

        def as_t(x):
            return torch.as_tensor(x, dtype=m_new.dtype, device=m_new.device)

        return m_new, as_t(mesh_phi), as_t(bd_vel)

    def tet_vertices(self, m_new) -> np.ndarray:
        """Full tet vertex array [mesh points; cell centres] for the
        particle mesh refresh (vertex layout of ``initCuda.H:112-124``)."""
        return np.concatenate([np.asarray(self.pm.points), fv.host(m_new.cc)], axis=0)


def update_moving_wall_bcs(m, u_bcs: fv.BoundaryCoeffs, bd_vel,
                           moving_patches: tuple) -> fv.BoundaryCoeffs:
    """Set movingWallVelocity patches to the instantaneous wall velocity."""
    if not moving_patches:
        return u_bcs
    b = u_bcs.b.clone()
    for name, _, start, cnt in m.patch_slices:
        if name in moving_patches:
            b[start : start + cnt] = bd_vel[start : start + cnt]
    return dataclasses.replace(u_bcs, b=b)
