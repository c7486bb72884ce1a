"""The flow case's inputs for the reference: the mesh's FV tables, the
initial fields and boundary conditions of ``0/``, transportProperties, the
numerics of fvSchemes and fvSolution and the turbulence closure.  A frozen
copy of the port's ``models/simple.py`` (those parts only).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from . import foamfile, fv, polymesh


@dataclasses.dataclass(frozen=True, eq=False)
class FlowState:
    u: torch.Tensor       # [nc, 3]
    p: torch.Tensor       # [nc]
    flux: torch.Tensor    # [nf]


def read_numerics(case_dir: str) -> dict:
    """div(phi,U) scheme + nNonOrthogonalCorrectors/nCorrectors/
    nOuterCorrectors from system/{fvSchemes,fvSolution}.  The div entry is
    parsed from raw text (its key contains parentheses)."""
    out = {"div_scheme": "upwind", "n_nonortho": 0, "n_correctors": 2,
           "n_outer": 1}
    fs = os.path.join(case_dir, "system", "fvSchemes")
    if os.path.exists(fs):
        with open(fs) as fh:
            txt = fh.read()
        mdiv = re.search(r"div\(phi,\s*U\)\s+([^;]+);", txt)
        ent = mdiv.group(1) if mdiv else ""
        if "limitedLinear" in ent:
            out["div_scheme"] = "limitedLinear"
        elif "linearUpwind" in ent:
            out["div_scheme"] = "linearUpwind"
        elif re.search(r"\blinear\b", ent):
            out["div_scheme"] = "linear"
    fsol = os.path.join(case_dir, "system", "fvSolution")
    if os.path.exists(fsol):
        d = foamfile.read(fsol)
        for block in ("SIMPLE", "PIMPLE", "PISO"):
            sub = d.get(block)
            if isinstance(sub, dict):
                out["n_nonortho"] = int(sub.get("nNonOrthogonalCorrectors", 0))
                out["n_correctors"] = int(sub.get("nCorrectors", 2))
                out["n_outer"] = int(sub.get("nOuterCorrectors", 1))
                break
    return out


def _exists(path):
    return os.path.exists(path) or os.path.exists(path + ".gz")


def load_flow_case(case_dir: str, pm=None, dtype=None, time_dir="0", device=None):
    """Read mesh + fields + transportProperties into solver inputs on
    ``device`` (default the card) in ``dtype`` (default float32).

    ``time_dir`` selects the field snapshot directory: "0" for a cold
    start, or the latest written time for a restart.  BC *specs* always
    come from ``0/``: the field writer tags boundaries "calculated"
    (which carries no inlet values).  Internal fields fall back to ``0/``
    when the restart dir misses a field.  Returns (m, state, u_bcs, p_bcs,
    nu, pin, p_tables).
    """
    if pm is None:
        pm = polymesh.read_polymesh(os.path.join(case_dir, "constant", "polyMesh"))
    m = fv.fv_mesh(pm, dtype=dtype, device=device)

    tp = {}
    tp_path = os.path.join(case_dir, "constant", "transportProperties")
    if os.path.exists(tp_path):
        tp = foamfile.read(tp_path)
    nu_e = tp.get("nu", 1e-5)
    # formats: `nu [dims] v;` or `nu v;`
    if isinstance(nu_e, list):
        nu = float([x for x in nu_e if isinstance(x, (int, float))][-1])
    else:
        nu = float(nu_e)

    def field_path(name):
        p = os.path.join(case_dir, str(time_dir), name)
        if _exists(p):
            return p
        return os.path.join(case_dir, "0", name)

    u0_path = field_path("U")
    p0_path = field_path("p")
    u_bc_path = os.path.join(case_dir, "0", "U")
    p_bc_path = os.path.join(case_dir, "0", "p")
    u_bc_spec = polymesh.read_field_bcs(u_bc_path) if os.path.exists(u_bc_path) else {}
    p_bc_spec = polymesh.read_field_bcs(p_bc_path) if os.path.exists(p_bc_path) else {}
    u_bcs = fv.make_bcs(
        m, {k: (e[0], e[1] if e[1] is not None else 0.0) for k, e in u_bc_spec.items()}, 3,
    )
    p_bcs = fv.make_bcs(
        m, {k: (e[0], e[1] if e[1] is not None else 0.0) for k, e in p_bc_spec.items()}, 1,
    )
    # time-varying pressure tables (uniformTotalPressure p0 ramps,
    # TJunction/0/p): {patch: [(t, p0), ...]}
    p_tables = {k: e[2] for k, e in p_bc_spec.items() if len(e) > 2}
    pin = not any(
        e[0] in ("fixedValue", "totalPressure", "uniformTotalPressure")
        for e in p_bc_spec.values()
    )
    u0 = (polymesh.read_field(u0_path, n_cells=pm.n_cells) if _exists(u0_path)
          else np.zeros((pm.n_cells, 3)))
    p0 = (polymesh.read_field(p0_path, n_cells=pm.n_cells) if _exists(p0_path)
          else np.zeros(pm.n_cells))
    u = torch.as_tensor(np.asarray(u0), dtype=m.dtype, device=m.device)
    state = FlowState(
        u=u,
        p=torch.as_tensor(np.asarray(p0).reshape(-1), dtype=m.dtype, device=m.device),
        flux=fv.flux_of(m, u, u_bcs),
    )
    return m, state, u_bcs, p_bcs, nu, pin, p_tables


def _pressure_matrix(m: fv.FvMesh, rau_f, p_bcs, pin: bool):
    """Laplacian(rAU) p  operator coefficients (symmetric), and the
    boundary source."""
    n_int = m.n_internal
    d_i = rau_f[:n_int] * m.delta
    d_b = rau_f[n_int:] * m.bd_delta
    diag = fv.index_sum(m.n_cells, [(m.own_i, d_i), (m.neighbour, d_i),
                                    (m.own_b, d_b * (1.0 - p_bcs.a))])
    if pin:
        diag[0] += 1.0
    src_b = fv.index_sum(m.n_cells, [(m.own_b, d_b * p_bcs.b[:, 0])])
    return fv.FvMatrix(diag=diag, lower=-d_i, upper=-d_i, source=src_b[:, None]), src_b


def turbulence_model(case_dir: str) -> str:
    """simulationType/RASModel from constant/turbulenceProperties."""
    path = os.path.join(case_dir, "constant", "turbulenceProperties")
    if not os.path.exists(path):
        return "laminar"
    d = foamfile.read(path)
    sim = str(d.get("simulationType", "laminar"))
    if sim == "laminar":
        return "laminar"
    if sim != "RAS":
        raise ValueError(
            f"unsupported simulationType {sim!r} in {path} "
            "(supported: laminar, RAS)"
        )
    ras = d.get("RAS", {})
    if not isinstance(ras, dict):
        raise ValueError(f"RAS sub-dictionary missing/malformed in {path}")
    if str(ras.get("turbulence", "on")) not in ("on", "true", "yes", "1"):
        return "laminar"
    model = str(ras.get("RASModel", ""))
    if model in ("kEpsilon", "kOmegaSST"):
        return model
    raise ValueError(
        f"unsupported RASModel {model!r} in {path} "
        "(supported: kEpsilon, kOmegaSST; the reference constructs any "
        "OpenFOAM model, applications/cudaParticlesPimpleFoam/"
        "createFields.H:53-61)"
    )


