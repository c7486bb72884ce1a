"""Multiple reference frames (MRF).

The port of ``cudaparticlesfoam_tpu/models/mrf.py``: OpenFOAM's
``IOMRFZoneList`` as the reference solver uses it
(``cudaParticlesPimpleFoam/UEqn.H:3-8`` — ``MRF.correctBoundaryVelocity(U)``,
``MRF.DDt(U)``; ``pEqn.H:12-20`` — ``MRF.makeRelative(phiHbyA)``;
``cudaParticlesPimpleFoam.C:151`` — ``MRF.update()``).

The velocity field stays ABSOLUTE (so the particle engine consumes it
unchanged); only the convective face fluxes are made relative to the
frame rotation, and the momentum equation gains the Coriolis source
``Omega x U`` over the zone cells.

Zone data is packed per cell / per face (zero outside all zones), so any
number of zones costs one elementwise pass: internal faces with BOTH
cells in a zone and boundary faces of zone cells (minus
``nonRotatingPatches``) get the rotational flux subtraction; zone-interface
faces stay absolute (OpenFOAM's ``setMRFFaces`` classification).  Torch
ops on the mesh's device; no kernel.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..io import foamfile, polymesh
from . import fv


@dataclasses.dataclass(frozen=True, eq=False)
class MRFZones:
    """Packed zone fields (zero omega = no frame)."""

    cell_omega: torch.Tensor    # [nc, 3]
    cell_origin: torch.Tensor   # [nc, 3]
    face_omega: torch.Tensor    # [nf, 3] (faces getting makeRelative)
    face_origin: torch.Tensor   # [nf, 3]


def _axis_omega(spec: dict):
    """(origin, omega_vector) from one MRFProperties zone dict.

    ``omega`` accepts ``constant <rad/s>`` (Function1 tables collapse to
    their first value)."""
    origin = np.asarray([float(x) for x in spec.get("origin", [0, 0, 0])])
    axis = np.asarray([float(x) for x in spec.get("axis", [0, 0, 1])])
    axis = axis / max(np.linalg.norm(axis), 1e-300)
    om = spec.get("omega", 0.0)
    if isinstance(om, list):
        # "constant 104.72" tokenizes to ["constant", 104.72]
        nums = [x for x in om if isinstance(x, (int, float))]
        om = nums[0] if nums else 0.0
    return origin, axis * float(om)


def from_case(case_dir: str, m: fv.FvMesh, pm) -> "MRFZones | None":
    """Read constant/MRFProperties (+ polyMesh/cellZones) onto ``m``'s
    device; None if absent."""
    path = os.path.join(case_dir, "constant", "MRFProperties")
    if not os.path.exists(path):
        return None
    props = foamfile.read(path)
    props.pop("FoamFile", None)
    zones = polymesh.read_cell_zones(os.path.join(case_dir, "constant", "polyMesh"))
    nc, nf, n_int = m.n_cells, m.n_faces, m.n_internal
    cell_om = np.zeros((nc, 3))
    cell_or = np.zeros((nc, 3))
    face_om = np.zeros((nf, 3))
    face_or = np.zeros((nf, 3))
    own = fv.host(m.owner)
    nei = fv.host(m.neighbour)
    for name, spec in props.items():
        if not isinstance(spec, dict):
            continue
        if str(spec.get("active", "yes")) in ("no", "false", "0"):
            continue
        zname = str(spec.get("cellZone", name))
        if zname in zones:
            cells = np.asarray(zones[zname], dtype=np.int64)
        elif zname in ("all", "none"):
            cells = np.arange(nc) if zname == "all" else np.empty(0, np.int64)
        else:
            raise ValueError(
                f"MRF zone {name!r}: cellZone {zname!r} not found in polyMesh/cellZones")
        origin, omega = _axis_omega(spec)
        in_zone = np.zeros(nc, bool)
        in_zone[cells] = True
        cell_om[in_zone] = omega
        cell_or[in_zone] = origin
        # rotational faces: internal with both cells in zone
        f_int = in_zone[own[:n_int]] & in_zone[nei]
        face_om[:n_int][f_int] = omega
        face_or[:n_int][f_int] = origin
        # boundary faces of zone cells, minus nonRotatingPatches
        nonrot = spec.get("nonRotatingPatches", [])
        if isinstance(nonrot, str):
            nonrot = [nonrot]
        nonrot = set(map(str, nonrot))
        f_bd = in_zone[own[n_int:]]
        for pname, _, start, cnt in m.patch_slices:
            if pname in nonrot:
                f_bd[start : start + cnt] = False
        face_om[n_int:][f_bd] = omega
        face_or[n_int:][f_bd] = origin

    def as_t(x):
        return torch.as_tensor(x, dtype=m.dtype, device=m.device)

    return MRFZones(cell_omega=as_t(cell_om), cell_origin=as_t(cell_or),
                    face_omega=as_t(face_om), face_origin=as_t(face_or))


def coriolis_source(mrf: MRFZones, m: fv.FvMesh, u):
    """Explicit Coriolis contribution to the momentum RHS:
    ``-(Omega x U) * V`` per zone cell (``MRF.DDt(U)`` moved to the RHS)."""
    return -torch.linalg.cross(mrf.cell_omega, u) * m.vol[:, None]


def frame_flux(mrf: MRFZones, m: fv.FvMesh):
    """Rotational face flux ``(Omega x (Cf - origin)) . Sf`` on the
    rotational faces (zero elsewhere)."""
    vr = torch.linalg.cross(mrf.face_omega, m.cf - mrf.face_origin)
    return torch.sum(vr * m.sf, dim=-1)


def make_relative(mrf: MRFZones, m: fv.FvMesh, flux):
    """``MRF.makeRelative(phi)``: subtract the frame flux."""
    return flux - frame_flux(mrf, m)


def correct_boundary_velocity(mrf: MRFZones, m: fv.FvMesh,
                              u_bcs: fv.BoundaryCoeffs) -> fv.BoundaryCoeffs:
    """``MRF.correctBoundaryVelocity(U)``: fixed-value (rotating wall)
    boundary faces inside the zone get ``U = Omega x (Cf - origin)``."""
    n_int = m.n_internal
    om_b = mrf.face_omega[n_int:]
    rotating = torch.any(om_b != 0.0, dim=1)
    fixed = u_bcs.a.reshape(-1)[: om_b.shape[0]] == 0.0
    sel = rotating & fixed
    u_rot = torch.linalg.cross(om_b, m.cf[n_int:] - mrf.face_origin[n_int:])
    return dataclasses.replace(u_bcs, b=torch.where(sel[:, None], u_rot, u_bcs.b))
