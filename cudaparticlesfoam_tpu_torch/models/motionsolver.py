"""Laplacian-smoothed mesh motion solvers (deforming meshes).

The port of ``cudaparticlesfoam_tpu/models/motionsolver.py``.  The
reference's coupled solver accepts any OpenFOAM ``dynamicFvMesh``
(``cudaParticlesPimpleFoam.C:144-170`` calls ``mesh.controlledUpdate()``);
beyond the rigid solid-body family (:mod:`.dynamicmesh`) the common
configuration is ``dynamicMotionSolverFvMesh`` with an fvMotionSolver:

* ``velocityLaplacian``            — solve lap(gamma, cellMotionU) = 0,
  points += dt * pointMotionU
* ``displacementLaplacian``        — solve lap(gamma, cellDisplacement) = 0,
  points = points0 + pointDisplacement
* ``velocityComponentLaplacian x`` — the scalar single-component variant

The motion Laplacian is assembled with the FV machinery (a zero-flux
:func:`~.fv.assemble_transport` is pure orthogonal diffusion) and solved
per component with Jacobi-CG on the mesh's device; cell values go to the
mesh points by inverse-distance volPointInterpolation (numpy, on the
host) with exact Dirichlet overrides on value patches (OpenFOAM's
pointConstraints essence).  The geometry rebuild, the swept-face
``meshPhi`` and the ALE flux correction are shared with the solid-body
path in :class:`.dynamicmesh.DynamicMesh`.

Boundary conditions come from ``0/pointMotionU`` / ``0/pointDisplacement``
(or the scalar ``0/pointMotionUx`` etc.).  Supported patch types:
fixedValue / uniformFixedValue (constant Function1), oscillatingDisplacement
(``amplitude*sin(omega*t)``), oscillatingVelocity, slip / symmetry /
zeroGradient / empty / calculated (zero-gradient in the cell solve,
interpolated at points).  Diffusivity models: ``uniform``,
``inverseDistance (patches...)`` and ``quadratic inverseDistance (...)``.
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

_VALUE_TYPES = ("fixedValue", "uniformFixedValue", "oscillatingDisplacement",
                "oscillatingVelocity")


@dataclasses.dataclass(frozen=True)
class PointBC:
    btype: str
    value: tuple = (0.0, 0.0, 0.0)      # fixed value / amplitude
    omega: float = 0.0                  # oscillating*

    def at(self, t: float) -> np.ndarray:
        v = np.asarray(self.value, dtype=np.float64)
        if self.btype == "oscillatingDisplacement":
            return v * math.sin(self.omega * t)
        if self.btype == "oscillatingVelocity":
            # d/dt of the oscillatingDisplacement point motion
            return v * self.omega * math.cos(self.omega * t)
        return v

    @property
    def is_value(self) -> bool:
        return self.btype in _VALUE_TYPES


@dataclasses.dataclass(frozen=True)
class MotionSolverMotion:
    """Parsed dynamicMotionSolverFvMesh + fvMotionSolver configuration."""

    kind: str                 # velocityLaplacian | displacementLaplacian |
    #                           velocityComponentLaplacian
    component: int            # 0/1/2 for the component solver, -1 otherwise
    diffusivity: tuple        # ("uniform",) | ("inverseDistance", names) |
    #                           ("quadratic-inverseDistance", names)
    bcs: tuple                # ((patch, PointBC), ...)


def _bc_value(entry):
    v = entry.get("value", entry.get("uniformValue", 0.0))

    def flat(x):
        if isinstance(x, list):
            out = []
            for e in x:
                out.extend(flat(e))
            return out
        return [x] if isinstance(x, (int, float)) else []

    nums = flat(v)
    if len(nums) >= 3:
        return tuple(float(x) for x in nums[-3:])
    if nums:
        return (float(nums[-1]),)
    return (0.0,)


def read_point_bcs(case_dir: str, kind: str, component: int):
    """Patch BC specs from the point-motion field of the active solver."""
    names = {
        "velocityLaplacian": ["pointMotionU"],
        "displacementLaplacian": ["pointDisplacement"],
        "velocityComponentLaplacian": ["pointMotionU" + "xyz"[component], "pointMotionU"],
    }[kind]
    d = None
    for nm in names:
        path = os.path.join(case_dir, "0", nm)
        if os.path.exists(path):
            d = foamfile.read(path)
            break
    if d is None:
        raise ValueError(f"motion solver {kind!r} needs 0/{names[0]} for its boundary "
                         "conditions")
    out = []
    for patch, entry in (d.get("boundaryField", {}) or {}).items():
        if not isinstance(entry, dict):
            continue
        btype = str(entry.get("type", "calculated"))
        if btype in ("fixedValue", "uniformFixedValue"):
            val = _bc_value(entry)
            if len(val) == 1:
                if component >= 0:      # scalar component field
                    val = tuple(val[0] if i == component else 0.0 for i in range(3))
                else:
                    val = (val[0], val[0], val[0])
            out.append((str(patch), PointBC("fixedValue", tuple(val))))
        elif btype in ("oscillatingDisplacement", "oscillatingVelocity"):
            amp = entry.get("amplitude", (0.0, 0.0, 0.0))
            amp = (tuple(float(x) for x in amp) if isinstance(amp, list)
                   else (float(amp), 0.0, 0.0))
            omega = float(entry.get("omega", 0.0))
            out.append((str(patch), PointBC(btype, amp, omega)))
        else:
            # slip / symmetry / zeroGradient / empty / calculated /
            # fixedNormalSlip: zero-gradient in the cell solve
            out.append((str(patch), PointBC("zeroGradient")))
    return tuple(out)


def parse_motion_solver(d: dict, case_dir: str):
    """MotionSolverMotion from a dynamicMeshDict body, or None."""
    solver = str(d.get("motionSolver", d.get("solver", "")))
    comp = -1
    if solver.startswith("velocityComponentLaplacian"):
        comp_tok = d.get("component", None)
        toks = solver.split()
        if comp_tok is None and len(toks) > 1:
            comp_tok = toks[1]
        comp = "xyz".index(str(comp_tok)) if comp_tok is not None else 0
        solver = "velocityComponentLaplacian"
    if solver not in ("velocityLaplacian", "displacementLaplacian",
                      "velocityComponentLaplacian"):
        return None
    coeffs = d.get(f"{solver}Coeffs", d)
    diff = coeffs.get("diffusivity", "uniform")
    if isinstance(diff, str):
        diff_spec = (str(diff),)
    else:
        toks = [str(t) for t in diff if isinstance(t, str)]
        patches = tuple(str(p) for t in diff if isinstance(t, list) for p in t)
        if "quadratic" in toks:
            diff_spec = ("quadratic-inverseDistance", patches)
        elif "inverseDistance" in toks:
            diff_spec = ("inverseDistance", patches)
        else:
            diff_spec = ("uniform",)
    return MotionSolverMotion(kind=solver, component=comp, diffusivity=diff_spec,
                              bcs=read_point_bcs(case_dir, solver, comp))


class LaplacianMotion:
    """Per-step point motion via the cell-Laplacian smoothing solve, on
    ``device`` (default the card) in ``dtype`` (default float32)."""

    def __init__(self, motion: MotionSolverMotion, pm, dtype=None, device=None):
        self.motion = motion
        self.pm = pm
        self.dtype = dtype
        self.device = canonical_device(device)
        self.points0 = np.asarray(pm.points, dtype=np.float64).copy()
        self._pts = self.points0.copy()
        # point <- cell adjacency (CSR) for volPointInterpolation
        sizes = np.diff(pm.face_offsets)
        own_rep = np.repeat(pm.owner, sizes)
        fv_flat = np.asarray(pm.face_verts)
        pairs = np.stack([fv_flat, own_rep], axis=1)
        nei_rep = np.repeat(pm.neighbour, sizes[: pm.n_internal_faces])
        pairs_n = np.stack([fv_flat[: len(nei_rep)], nei_rep], axis=1)
        allp = np.unique(np.concatenate([pairs, pairs_n]), axis=0)
        self._pt_cells = allp            # sorted by point id
        self._pt_off = np.searchsorted(allp[:, 0], np.arange(len(pm.points) + 1))
        # patch -> point ids (boundary overrides)
        self._patch_pts = {}
        for name, _, start, cnt in pm.patches:
            lo, hi = pm.face_offsets[start], pm.face_offsets[start + cnt]
            self._patch_pts[name] = np.unique(fv_flat[lo:hi])
        self._gamma_cells = None         # cached cell diffusivity (topology-fixed)

    # -- diffusivity -------------------------------------------------------
    def _cell_gamma(self, cc: np.ndarray) -> np.ndarray:
        spec = self.motion.diffusivity
        if spec[0] == "uniform":
            return np.ones(len(cc))
        if self._gamma_cells is not None:
            return self._gamma_cells
        names = spec[1]
        pm = self.pm
        fv_flat = np.asarray(pm.face_verts)
        ctrs = []
        for name, _, start, cnt in pm.patches:
            if name in names:
                for f in range(start, start + cnt):
                    lo, hi = pm.face_offsets[f], pm.face_offsets[f + 1]
                    ctrs.append(np.mean(self.points0[fv_flat[lo:hi]], axis=0))
        if not ctrs:
            raise ValueError(f"inverseDistance diffusivity patches {names} not found")
        ctrs = np.asarray(ctrs)
        d = np.full(len(cc), np.inf)
        for i0 in range(0, len(cc), 4096):
            sl = slice(i0, min(i0 + 4096, len(cc)))
            dd = np.linalg.norm(cc[sl][:, None, :] - ctrs[None], axis=-1)
            d[sl] = dd.min(axis=1)
        g = 1.0 / np.maximum(d, 1e-12)
        if spec[0].startswith("quadratic"):
            g = g * g
        self._gamma_cells = g
        return g

    # -- the per-step solve --------------------------------------------------
    def points_at(self, t_new: float, dt: float) -> np.ndarray:
        """New point positions (also advances the stored state)."""
        pm = self.pm
        pm.points = self._pts            # assemble on the current geometry
        m = fv.fv_mesh(pm, dtype=self.dtype, device=self.device)
        cc = fv.host(m.cc).astype(np.float64)
        gamma_c = self._cell_gamma(cc)
        # face diffusivity: linear interpolation, boundary takes owner
        n_int = m.n_internal
        w = fv.host(m.w).astype(np.float64)
        own = fv.host(m.owner)
        nei = fv.host(m.neighbour)
        gf = np.empty(m.n_faces)
        gf[:n_int] = w * gamma_c[own[:n_int]] + (1 - w) * gamma_c[nei]
        gf[n_int:] = gamma_c[own[n_int:]]

        spec = {}
        for patch, bc in self.motion.bcs:
            if bc.is_value or bc.btype == "fixedValue":
                spec[patch] = ("fixedValue", tuple(bc.at(t_new)))
            else:
                spec[patch] = ("zeroGradient",)
        bcs = fv.make_bcs(m, spec, n_comp=3)
        A = fv.assemble_transport(
            m, torch.zeros(m.n_faces, dtype=m.dtype, device=m.device),
            torch.as_tensor(gf, dtype=m.dtype, device=m.device), bcs, n_comp=3)
        comps = [self.motion.component] if self.motion.component >= 0 else [0, 1, 2]
        u_cell = np.zeros((m.n_cells, 3))
        for c in comps:
            x, _, _ = fv.cg_solve(m, A, A.source[:, c].contiguous(),
                                  torch.zeros(m.n_cells, dtype=m.dtype, device=m.device),
                                  tol=1e-8, max_iter=2000)
            u_cell[:, c] = fv.host(x).astype(np.float64)

        # volPointInterpolation: inverse-distance over adjacent cells
        pts = self._pts
        pc = self._pt_cells
        d = np.linalg.norm(pts[pc[:, 0]] - cc[pc[:, 1]], axis=1)
        wgt = 1.0 / np.maximum(d, 1e-12)
        num = np.zeros((len(pts), 3))
        den = np.zeros(len(pts))
        np.add.at(num, pc[:, 0], wgt[:, None] * u_cell[pc[:, 1]])
        np.add.at(den, pc[:, 0], wgt)
        u_pt = num / np.maximum(den, 1e-300)[:, None]
        # exact Dirichlet override on value patches (pointConstraints)
        for patch, bc in self.motion.bcs:
            if bc.is_value or bc.btype == "fixedValue":
                ids = self._patch_pts.get(patch)
                if ids is not None and len(ids):
                    u_pt[ids] = bc.at(t_new)

        if self.motion.kind == "displacementLaplacian":
            new_pts = self.points0 + u_pt
        else:
            new_pts = self._pts + dt * u_pt
        self._pts = new_pts
        return new_pts
