"""Shared set-up of the PyTorch port's tests (every ``tests/test_torch_*.py``
imports this module first).

The port's tests run beside the JAX package's under several pytest
workers on a machine with few cores.  Torch would start one intra-op
thread per core in every worker; with the workers' XLA thread pools on
top, the machine is oversubscribed many times over, and a JAX test that
is sensitive to timing can fail in one run and pass in the next.  The
port's CPU tests are small (a few thousand lanes), so one thread each is
also the faster setting.
"""

import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")   # the port allocates on the card unless told otherwise

import os  # noqa: E402
import shutil  # noqa: E402

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PITZ = os.path.join(REPO, "tutorials", "incompressible", "cudaParticlesUncoupledFoam",
                    "pitzDaily")
TJUNC = os.path.join(REPO, "tutorials", "incompressible", "cudaParticlesPimpleFoam",
                     "TJunction")
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")


def make_pitz_case(dst, num_particles=200, delta_t=0.01, u_value=(1.0, 0.0, 0.0),
                   shear=False, u_time="282", extra_dict=None) -> str:
    """A copy of the repo's pitzDaily tutorial under ``dst``, shrunk as
    tests/test_cases.py's ``make_case`` does (numParticles, deltaT, no
    function objects), with a synthetic converged U at ``u_time``: uniform
    ``u_value``, or with ``shear`` the field of tests/test_golden.py's
    driver anchor (u_x = 1 + 20 y at the cell centres).  Built with the
    port's own io modules, so it needs no jax."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh, foamfile, polymesh

    case = os.path.join(str(dst), "pitzDaily")
    shutil.copytree(PITZ, case)
    d = foamfile.read(os.path.join(case, "system", "cudaParticlesDict"))
    d.pop("FoamFile", None)
    d["numParticles"] = num_particles
    d.update(extra_dict or {})
    foamfile.write(os.path.join(case, "system", "cudaParticlesDict"), d,
                   obj_name="cudaParticlesDict")
    cd = foamfile.read(os.path.join(case, "system", "controlDict"))
    cd.pop("FoamFile", None)
    cd.pop("functions", None)
    cd["deltaT"] = delta_t
    foamfile.write(os.path.join(case, "system", "controlDict"), cd, obj_name="controlDict")
    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    if shear:
        ctrs, _ = polymesh.cell_centres_volumes(pm)
        u = np.zeros((pm.n_cells, 3))
        u[:, 0] = 1.0 + 20.0 * ctrs[:, 1]
    else:
        u = np.tile(u_value, (pm.n_cells, 1))
    os.makedirs(os.path.join(case, u_time), exist_ok=True)
    polymesh.write_field(os.path.join(case, u_time, "U"), "U", u)
    return case


def recorded_noise(monkeypatch, noise):
    """Replay ``noise`` [cycles, n, 3] as the port's per-step Brownian
    draw (``ops.fused._brownian_noise``): step s draws ``noise[s]``."""
    import torch

    from cudaparticlesfoam_tpu_torch.ops import fused

    def draw(seed, step, n, dtype, device, mode="threefry"):
        assert n == noise.shape[1], (n, noise.shape)
        return torch.as_tensor(noise[step], dtype=dtype, device=device)

    monkeypatch.setattr(fused, "_brownian_noise", draw)


# ---------------------------------------------------------------------------
# flow cases (the port's tests of models/{fv,simple,turbulence,functions})
# ---------------------------------------------------------------------------

_HDR = "FoamFile { version 2.0; format ascii; class %s; object %s; }\n"
_VEL, _PRS = "[0 1 -1 0 0 0 0]", "[0 2 -2 0 0 0 0]"
# tests/test_flow.py's channel: 2 x 0.1 x 0.01, 40 x 16 x 1 cells, 2-D
CHANNEL_VERTICES = ("(0 0 0) (2 0 0) (2 0.1 0) (0 0.1 0) "
                    "(0 0 0.01) (2 0 0.01) (2 0.1 0.01) (0 0.1 0.01)")
# the channel with parallelogram cells: the non-orthogonal correction is live
SKEW_VERTICES = ("(0 0 0) (2 0.3 0) (2 0.4 0) (0 0.1 0) "
                 "(0 0 0.01) (2 0.3 0.01) (2 0.4 0.01) (0 0.1 0.01)")
# a 3-D duct, 1 x 0.1 x 0.1: with an oblique inlet no velocity component is
# zero, so limitedLinear's V-limiter (the min over components) sees no
# rounding noise of an empty direction
DUCT_VERTICES = ("(0 0 0) (1 0 0) (1 0.1 0) (0 0.1 0) "
                 "(0 0 0.1) (1 0 0.1) (1 0.1 0.1) (0 0.1 0.1)")


def channel_bmd(vertices=CHANNEL_VERTICES, cells=(40, 16, 1), sides="empty") -> str:
    """blockMeshDict of tests/test_flow.py's channel (inlet, outlet,
    walls, frontAndBack); other vertices give a skewed channel or a duct,
    ``sides`` is frontAndBack's patch type."""
    return (_HDR % ("dictionary", "blockMeshDict") + f"scale 1;\nvertices ( {vertices} );\n"
            "blocks ( hex (0 1 2 3 4 5 6 7) (%d %d %d) simpleGrading (1 1 1) );\n" % cells
            + "edges ();\nboundary (\n inlet { type patch; faces ((0 4 7 3)); }\n"
            " outlet { type patch; faces ((1 2 6 5)); }\n"
            " walls { type wall; faces ((0 1 5 4) (3 7 6 2)); }\n"
            f" frontAndBack {{ type {sides}; faces ((0 3 2 1) (4 5 6 7)); }}\n);\n")


def foam_field(name: str, dims: str, internal: str, bcs: dict, cls="volScalarField") -> str:
    body = "".join(f" {k} {{ {v} }}\n" for k, v in bcs.items())
    return (_HDR % (cls, name)
            + f"dimensions {dims};\ninternalField {internal};\nboundaryField {{\n{body}}}\n")


def channel_u(internal="uniform (1 0 0)", inlet="type fixedValue; value uniform (1 0 0);",
              outlet="type zeroGradient;", sides="type empty;", walls="type noSlip;") -> str:
    return foam_field("U", _VEL, internal, {"inlet": inlet, "outlet": outlet, "walls": walls,
                                            "frontAndBack": sides}, cls="volVectorField")


def channel_p(sides="type empty;") -> str:
    return foam_field("p", _PRS, "uniform 0", {
        "inlet": "type zeroGradient;", "outlet": "type fixedValue; value uniform 0;",
        "walls": "type zeroGradient;", "frontAndBack": sides})


def _turbulence_files(model: str, sides: str) -> dict:
    """tests/test_flow.py's turbulent channel (Re ~ 1e4) for ``model``."""
    second, dims, value, wf = {
        "kEpsilon": ("epsilon", "[0 2 -3 0 0 0 0]", "0.000765", "epsilonWallFunction"),
        "kOmegaSST": ("omega", "[0 0 -1 0 0 0 0]", "2.2", "omegaWallFunction"),
    }[model]

    def turb(name, dims_, v, wall):
        return foam_field(name, dims_, f"uniform {v}", {
            "inlet": f"type fixedValue; value uniform {v};", "outlet": "type zeroGradient;",
            "walls": f"type {wall}; value uniform {v};", "frontAndBack": sides})

    return {
        "constant/turbulenceProperties": _HDR % ("dictionary", "turbulenceProperties")
        + f"simulationType RAS;\nRAS {{ RASModel {model}; turbulence on; }}\n",
        "0/k": turb("k", "[0 2 -2 0 0 0 0]", "0.00375", "kqRWallFunction"),
        f"0/{second}": turb(second, dims, value, wf),
    }


def make_channel_case(dst, name="chan", model="laminar", bmd=None, u=None, p=None,
                      sides="type empty;", nu=None) -> str:
    """tests/test_flow.py's channel case under ``dst``/``name``, written
    with no jax: nu 0.01 laminar, or with ``model`` ("kEpsilon",
    "kOmegaSST") the turbulent channel of its kEpsilon/kOmegaSST tests (nu
    1e-5, k and epsilon/omega).  ``bmd``, ``u``, ``p`` replace the mesh
    and the fields; returns the case directory (no polyMesh: build it
    with ``io.blockmesh.generate``)."""
    case = os.path.join(str(dst), name)
    files = {
        "system/blockMeshDict": bmd or channel_bmd(),
        "system/controlDict": _HDR % ("dictionary", "controlDict")
        + "application simpleFoam; startFrom latestTime; startTime 0; endTime 10; deltaT 1;\n",
        "constant/transportProperties": _HDR % ("dictionary", "transportProperties")
        + "nu [0 2 -1 0 0 0 0] %g;\n" % (nu or (0.01 if model == "laminar" else 1e-5)),
        "0/U": u or channel_u(sides=sides),
        "0/p": p or channel_p(sides=sides),
    }
    if model != "laminar":
        files.update(_turbulence_files(model, sides))
    for rel, text in files.items():
        os.makedirs(os.path.join(case, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(case, rel), "w") as fh:
            fh.write(text)
    return case


FLOW_CASES = {
    "channel": {},
    "skew": dict(bmd=channel_bmd(SKEW_VERTICES)),
    "duct": dict(bmd=channel_bmd(DUCT_VERTICES, (10, 4, 4), sides="wall"),
                 u=channel_u(inlet="type fixedValue; value uniform (1 0.1 0.05);",
                             sides="type noSlip;"),
                 p=channel_p(sides="type zeroGradient;")),
    # the field starts reversed, so the inletOutlet outlet sees backflow
    "backflow": dict(u=channel_u(internal="uniform (-1 0 0)",
                                 outlet="type inletOutlet; inletValue uniform (0 0 0); "
                                        "value uniform (0 0 0);")),
    "kEpsilon": dict(model="kEpsilon"),
    "kOmegaSST": dict(model="kOmegaSST"),
}

# SIMPLE parity cases: (flow case, p_solver, div_scheme, n_nonortho, p_tol).
# Jacobi-CG takes ~340 iterations a solve on the channel; stopped at the
# default p_tol 1e-7 it leaves each solve an error that two orders of
# summation carry apart from one SIMPLE iteration to the next (7.7e-9 after
# 9 iterations), so its cases solve to 1e-10
FLOW_PARITY = {
    "laminar-cg": ("channel", "cg", "upwind", 0, 1e-10),
    "laminar-amg": ("channel", "amg", "upwind", 0, 1e-7),
    "linearUpwind": ("channel", "amg", "linearUpwind", 0, 1e-7),
    "linearUpwind-cg": ("channel", "cg", "linearUpwind", 0, 1e-10),
    "limitedLinear": ("duct", "amg", "limitedLinear", 0, 1e-7),
    "limitedLinear-cg": ("duct", "cg", "limitedLinear", 0, 1e-10),
    "nonortho": ("skew", "amg", "linearUpwind", 1, 1e-7),
    "backflow": ("backflow", "amg", "upwind", 0, 1e-7),
    "kEpsilon": ("kEpsilon", "amg", "linearUpwind", 0, 1e-7),
    "kOmegaSST": ("kOmegaSST", "amg", "linearUpwind", 0, 1e-7),
}


def make_flow_case(dst, name) -> str:
    """``FLOW_CASES[name]`` under ``dst``/``name``."""
    return make_channel_case(dst, name=name, **FLOW_CASES[name])


def simple_steps(simple, turbulence, m, st, u_bcs, p_bcs, cfg, amg, closure, n):
    """``n`` iterations of solve_steady's loop (SIMPLE, then the closure
    update) with either package's ``simple`` and ``turbulence`` modules;
    ``closure`` is None or (model, state, bcs_a, bcs_b, wall_info).
    Returns (state, closure, CG counts)."""
    its = []
    for _ in range(n):
        nut = nut_bd = None
        if closure is not None:
            model, kes, ba, bb, wi = closure
            nut, nut_bd = kes.nut, turbulence.wall_nut_bd(m, wi, kes.nut, kes.k, cfg.nu)
        st, res = simple.simple_iteration(m, st, u_bcs, p_bcs, cfg, nut=nut, amg=amg,
                                          nut_bd=nut_bd)
        if closure is not None:
            kes = turbulence.model_step(model, m, kes, st.u, u_bcs, st.flux, ba, bb, wi,
                                        cfg.nu)
            closure = (model, kes, ba, bb, wi)
        its.append(int(res["p_iters"]))
    return st, closure, its


# ---------------------------------------------------------------------------
# coupled cases (the port's tests of models/{pimple,coupled,mrf,fvoptions,
# dynamicmesh,motionsolver}.py): copies of the JAX tests' constructions,
# written with the port's io only
# ---------------------------------------------------------------------------


def shrink_tjunction(dst, num_particles=2000, save_interval=5):
    """tests/test_coupled_e2e.py's shrunk TJunction under ``dst``: a copy of
    the repo's tutorial at 1/5 resolution per axis (248k cells -> 2,080),
    ``num_particles`` particles, the particle window opened at t=0 (the
    tutorial opens it at 0.5) and ``save_interval``."""
    from cudaparticlesfoam_tpu_torch.io import foamfile

    case = os.path.join(str(dst), "TJunction")
    shutil.copytree(TJUNC, case)
    bm = os.path.join(case, "system", "blockMeshDict")
    with open(bm) as fh:
        s = fh.read()
    s = s.replace("(200 20 20)", "(40 4 4)").replace("(20 20 20)", "(4 4 4)")
    s = s.replace("(20 200 20)", "(4 40 4)")
    with open(bm, "w") as fh:
        fh.write(s)
    path = os.path.join(case, "system", "cudaParticlesDict")
    d = foamfile.read(path)
    d.pop("FoamFile", None)
    d["numParticles"] = num_particles
    d["startTime"] = 0.0
    d["saveInterval"] = save_interval
    foamfile.write(path, d, obj_name="cudaParticlesDict")
    return case


def write_polymesh_of(case) -> None:
    """constant/polyMesh of ``case``'s blockMeshDict (the port's blockmesh)."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh, polymesh

    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    polymesh.write_polymesh(pm, os.path.join(case, "constant", "polyMesh"))
    return pm


def write_files(case, files: dict) -> str:
    for rel, text in files.items():
        path = os.path.join(str(case), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
    return str(case)


# tests/test_mrf.py's box: 1 x 1 x 0.1 about the z axis, 10 x 10 x 2 cells
MRF_BOX_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices (
 (-0.5 -0.5 0) (0.5 -0.5 0) (0.5 0.5 0) (-0.5 0.5 0)
 (-0.5 -0.5 0.1) (0.5 -0.5 0.1) (0.5 0.5 0.1) (-0.5 0.5 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (10 10 2) simpleGrading (1 1 1) );
edges ();
boundary (
 walls { type wall; faces ((0 4 7 3) (1 2 6 5) (0 1 5 4) (3 7 6 2)); }
 frontAndBack { type patch; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def mrf_props(omega=10.0, zone="rotor", nonrot=()) -> str:
    """tests/test_mrf.py's write_mrf_props text."""
    return ("FoamFile { version 2.0; format ascii; class dictionary; object MRFProperties; }\n"
            "zone1\n{\n"
            f"    cellZone {zone};\n    active yes;\n"
            f"    nonRotatingPatches ({' '.join(nonrot)});\n"
            "    origin (0 0 0);\n    axis (0 0 1);\n"
            f"    omega constant {omega};\n}}\n")


def cell_zones_text(name, cells) -> str:
    """tests/test_mrf.py's write_cell_zones text."""
    return ("FoamFile { version 2.0; format ascii; class regIOobject; object cellZones; }\n"
            "1\n(\n" + f"{name}\n{{\n    type cellZone;\ncellLabels      List<label>\n"
            f"{len(cells)}\n(\n" + "\n".join(str(c) for c in cells) + "\n)\n;\n}\n)\n")


def make_mrf_case(dst) -> str:
    """tests/test_mrf.py's make_mrf_case: a spun closed box with MRFProperties
    and cellZones (omega 3 about z, frontAndBack non-rotating)."""
    case = os.path.join(str(dst), "mrfcase")
    write_files(case, {
        "system/blockMeshDict": MRF_BOX_BMD,
        "system/controlDict": "FoamFile { object controlDict; }\n"
        "application cudaParticlesPimpleFoam;\nstartFrom startTime;\nstartTime 0;\n"
        "endTime 1;\ndeltaT 0.01;\nwriteControl timeStep;\nwriteInterval 1000;\n",
        "system/cudaParticlesDict": "FoamFile { object cudaParticlesDict; }\n"
        "seedingBox (-0.2 -0.2 0.02) (0.2 0.2 0.08);\nnumParticles 100;\n"
        "startTime 0;\nendTime 10;\ndt 0.005;\ndiffusionCoeff 1e-6;\nsaveInterval 10;\n",
        "system/fvSolution": "FoamFile { object fvSolution; }\n"
        "PIMPLE { nOuterCorrectors 1; nCorrectors 2; }\n",
        "constant/transportProperties": "FoamFile { object transportProperties; }\n"
        "nu [0 2 -1 0 0 0 0] 0.01;\n",
        "0/U": "FoamFile { class volVectorField; object U; }\n"
        "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\n"
        "boundaryField { walls { type noSlip; } frontAndBack { type zeroGradient; } }\n",
        "0/p": "FoamFile { class volScalarField; object p; }\n"
        "dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\n"
        "boundaryField { walls { type zeroGradient; } frontAndBack { type zeroGradient; } }\n",
    })
    pm = write_polymesh_of(case)
    write_files(case, {"constant/polyMesh/cellZones": cell_zones_text("rotor",
                                                                      range(pm.n_cells)),
                       "constant/MRFProperties": mrf_props(3.0, nonrot=("frontAndBack",))})
    return case


# tests/test_fvoptions.py's channel: 1 x 0.1 x 0.01, 20 x 16 x 1 cells
FVO_CHANNEL_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices (
 (0 0 0) (1 0 0) (1 0.1 0) (0 0.1 0)
 (0 0 0.01) (1 0 0.01) (1 0.1 0.01) (0 0.1 0.01)
);
blocks ( hex (0 1 2 3 4 5 6 7) (20 16 1) simpleGrading (1 1 1) );
edges ();
boundary (
 inlet { type patch; faces ((0 4 7 3)); }
 outlet { type patch; faces ((1 2 6 5)); }
 walls { type wall; faces ((0 1 5 4) (3 7 6 2)); }
 frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""

# tests/test_dynamicmesh.py's closed box (8 x 8 x 2 cells) and its cases
OSC_BOX_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices (
 (0 0 0) (1 0 0) (1 1 0) (0 1 0)
 (0 0 0.2) (1 0 0.2) (1 1 0.2) (0 1 0.2)
);
blocks ( hex (0 1 2 3 4 5 6 7) (8 8 2) simpleGrading (1 1 1) );
edges ();
boundary (
 walls { type wall; faces ((0 4 7 3) (1 2 6 5) (0 1 5 4) (3 7 6 2)
                           (0 3 2 1) (4 5 6 7)); }
);
"""

TWO_ZONE_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices (
 (0 0 0) (1 0 0) (1 1 0) (0 1 0)
 (0 0 0.2) (1 0 0.2) (1 1 0.2) (0 1 0.2)
 (2 0 0) (2 1 0) (2 0 0.2) (2 1 0.2)
);
blocks (
 hex (0 1 2 3 4 5 6 7) rotor (6 6 2) simpleGrading (1 1 1)
 hex (1 8 9 2 5 10 11 6) (6 6 2) simpleGrading (1 1 1)
);
edges ();
boundary (
 walls { type wall; faces ((0 4 7 3) (8 9 11 10) (0 1 5 4) (1 8 10 5)
                           (3 7 6 2) (2 6 11 9)
                           (0 3 2 1) (4 5 6 7) (1 2 9 8) (5 10 11 6)); }
);
"""

LAP_CHANNEL_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
scale 1;
vertices (
 (0 0 0) (2 0 0) (2 1 0) (0 1 0)
 (0 0 0.2) (2 0 0.2) (2 1 0.2) (0 1 0.2)
);
blocks ( hex (0 1 2 3 4 5 6 7) (12 6 2) simpleGrading (1 1 1) );
edges ();
boundary (
 movingWall { type wall; faces ((0 4 7 3)); }
 farWall    { type wall; faces ((1 2 6 5)); }
 sides      { type wall; faces ((0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""

_UPWIND = "FoamFile { object fvSchemes; }\ndivSchemes { default none; \"div.*\" Gauss upwind; }\n"
_PISO2 = ("FoamFile { object fvSolution; }\n"
          "PIMPLE { nOuterCorrectors 1; nCorrectors 2; nNonOrthogonalCorrectors 0; }\n")
_NU001 = "FoamFile { object transportProperties; }\nnu [0 2 -1 0 0 0 0] 0.01;\n"


def make_oscillating_case(dst, n_particles=200) -> str:
    """tests/test_dynamicmesh.py's make_oscillating_case: a closed box
    oscillating in x (amplitude 0.2, omega 6.283), movingWallVelocity walls."""
    case = os.path.join(str(dst), "oscbox")
    write_files(case, {
        "system/blockMeshDict": OSC_BOX_BMD,
        "system/controlDict": "FoamFile { object controlDict; }\n"
        "application cudaParticlesPimpleFoam;\nstartFrom startTime;\nstartTime 0;\n"
        "endTime 1;\ndeltaT 0.02;\nwriteControl timeStep;\nwriteInterval 1000;\n",
        "system/cudaParticlesDict": "FoamFile { object cudaParticlesDict; }\n"
        f"seedingBox (0.3 0.3 0.05) (0.7 0.7 0.15);\nnumParticles {n_particles};\n"
        "startTime 0;\nendTime 10;\ndt 0.01;\ndiffusionCoeff 1e-6;\nsaveInterval 10;\n",
        "system/fvSchemes": _UPWIND,
        "system/fvSolution": _PISO2,
        "constant/transportProperties": _NU001,
        "constant/dynamicMeshDict": "FoamFile { object dynamicMeshDict; }\n"
        "dynamicFvMesh solidBodyMotionFvMesh;\n"
        "solidBodyMotionFunction oscillatingLinearMotion;\n"
        "oscillatingLinearMotionCoeffs { amplitude (0.2 0 0); omega 6.283; }\n",
        "0/U": "FoamFile { class volVectorField; object U; }\n"
        "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\n"
        "boundaryField { walls { type movingWallVelocity; value uniform (0 0 0); } }\n",
        "0/p": "FoamFile { class volScalarField; object p; }\n"
        "dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\n"
        "boundaryField { walls { type zeroGradient; } }\n",
    })
    write_polymesh_of(case)
    return case


def make_motion_solver_case(dst, solver="velocityLaplacian", diffusivity="uniform;",
                            flow=False) -> str:
    """tests/test_dynamicmesh.py's make_motion_solver_case (a 2 x 1 x 0.2
    channel whose movingWall is driven by a Laplacian motion solver); with
    ``flow`` also the PIMPLE files of its coupled-flow tests (an open far
    end)."""
    case = os.path.join(str(dst), "lapcase")
    field = "pointDisplacement" if solver == "displacementLaplacian" else "pointMotionU"
    if solver == "displacementLaplacian":
        mv_bc = ("movingWall { type oscillatingDisplacement; amplitude (0.2 0 0); "
                 "omega 6.2832; value uniform (0 0 0); }")
    else:
        mv_bc = "movingWall { type fixedValue; value uniform (0.5 0 0); }"
    files = {
        "system/blockMeshDict": LAP_CHANNEL_BMD,
        "constant/dynamicMeshDict": "FoamFile { object dynamicMeshDict; }\n"
        "dynamicFvMesh dynamicMotionSolverFvMesh;\n"
        "motionSolverLibs (\"libfvMotionSolvers.so\");\n"
        f"motionSolver {solver};\ndiffusivity {diffusivity}\n",
        f"0/{field}": f"FoamFile {{ class pointVectorField; object {field}; }}\n"
        "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\n"
        f"boundaryField {{\n {mv_bc}\n farWall {{ type fixedValue; value uniform (0 0 0); }}\n"
        " sides { type slip; }\n}\n",
    }
    if flow:
        files.update({
            "system/controlDict": "FoamFile { object controlDict; }\n"
            "application pimpleFoam; startFrom startTime; startTime 0; endTime 1;\n"
            "deltaT 0.01; writeControl timeStep; writeInterval 1000;\n",
            "system/fvSolution": "FoamFile { object fvSolution; }\n"
            "solvers { p { solver GAMG; tolerance 1e-7; } }\n"
            "PIMPLE { nOuterCorrectors 1; nCorrectors 2; nNonOrthogonalCorrectors 0; }\n",
            "system/fvSchemes": _UPWIND,
            "constant/transportProperties": _NU001,
            "0/U": "FoamFile { class volVectorField; object U; }\n"
            "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\n"
            "boundaryField { movingWall { type movingWallVelocity; value uniform (0 0 0); }\n"
            " farWall { type zeroGradient; } sides { type noSlip; } }\n",
            "0/p": "FoamFile { class volScalarField; object p; }\n"
            "dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\n"
            "boundaryField { movingWall { type zeroGradient; } "
            "farWall { type fixedValue; value uniform 0; } sides { type zeroGradient; } }\n",
        })
    write_files(case, files)
    write_polymesh_of(case)
    return case


class FakeCase:
    """The minimal case object FlowSolver.from_case reads (the JAX tests'
    ``_FakeCase``)."""

    def __init__(self, case_dir, poly, time_value=0.0, time_dir="0"):
        self.case_dir, self.poly = case_dir, poly
        self.time_value, self.time_dir = time_value, time_dir


_NUM = r"-?\d+\.?\d*(?:[eE][+-]?\d+)?"


def assert_logs_match(got, want, rel=1e-6, floor=1e-12):
    """Two packages' log lines are the same text, number for number: each
    number within ``rel`` of the other's, or both below ``floor`` in
    magnitude (a residual at rounding level, e.g. 1e-17, follows the order
    of summation, not the solve)."""
    import re

    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert re.sub(_NUM, "#", g) == re.sub(_NUM, "#", w), (g, w)
        for a, b in zip(re.findall(_NUM, g), re.findall(_NUM, w)):
            a, b = float(a), float(b)
            assert abs(a - b) <= rel * abs(b) or max(abs(a), abs(b)) < floor, (g, w)


def make_mvf_channel_case(dst) -> str:
    """tests/test_fvoptions.py's force-driven channel as a case directory: U
    zeroGradient at both ends (noSlip walls), p fixed and equal at both
    ends, so that only the meanVelocityForce (Ubar 1 m/s, system/fvOptions)
    drives the flow; nu 0.01."""
    case = os.path.join(str(dst), "mvfchan")
    bc = "inlet {{ {i} }} outlet {{ {o} }} walls {{ {w} }} frontAndBack {{ type empty; }}"
    write_files(case, {
        "system/blockMeshDict": FVO_CHANNEL_BMD,
        "system/controlDict": "FoamFile { object controlDict; }\n"
        "application cudaParticlesPimpleFoam;\nstartFrom startTime;\nstartTime 0;\n"
        "endTime 1;\ndeltaT 0.02;\nwriteControl timeStep;\nwriteInterval 1000;\n",
        "system/fvSolution": _PISO2,
        "constant/transportProperties": _NU001,
        "system/fvOptions": "FoamFile { version 2.0; format ascii; object fvOptions; }\n"
        "momentumSource {\n type meanVelocityForce;\n meanVelocityForceCoeffs {\n"
        "  selectionMode all;\n  fields (U);\n  Ubar (1 0 0);\n }\n}\n",
        "0/U": "FoamFile { class volVectorField; object U; }\n"
        "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\nboundaryField { "
        + bc.format(i="type zeroGradient;", o="type zeroGradient;", w="type noSlip;") + " }\n",
        "0/p": "FoamFile { class volScalarField; object p; }\n"
        "dimensions [0 2 -2 0 0 0 0];\ninternalField uniform 0;\nboundaryField { "
        + bc.format(i="type fixedValue; value uniform 0;", o="type fixedValue; value uniform 0;",
                    w="type zeroGradient;") + " }\n",
    })
    write_polymesh_of(case)
    return case


def refresh_box_case(dst, n) -> str:
    """A unit cube of n^3 hex cells whose x=0 wall is driven at (0.5, 0, 0)
    by a velocityLaplacian motion solver (the far wall pinned, the sides
    slip): the moved meshes of the geometry-refresh checks."""
    case = os.path.join(str(dst), f"box{n}")
    bmd = LAP_CHANNEL_BMD.replace("(2 0 0) (2 1 0)", "(1 0 0) (1 1 0)").replace(
        "(2 0 0.2) (2 1 0.2)", "(1 0 1) (1 1 1)").replace(
        "(0 0 0.2)", "(0 0 1)").replace("(0 1 0.2)", "(0 1 1)").replace(
        "(12 6 2)", f"({n} {n} {n})")
    write_files(case, {
        "system/blockMeshDict": bmd,
        "constant/dynamicMeshDict": "FoamFile { object dynamicMeshDict; }\n"
        "dynamicFvMesh dynamicMotionSolverFvMesh;\n"
        "motionSolverLibs (\"libfvMotionSolvers.so\");\nmotionSolver velocityLaplacian;\n"
        "diffusivity uniform;\n",
        "0/pointMotionU": "FoamFile { class pointVectorField; object pointMotionU; }\n"
        "dimensions [0 1 -1 0 0 0 0];\ninternalField uniform (0 0 0);\nboundaryField {\n"
        " movingWall { type fixedValue; value uniform (0.5 0 0); }\n"
        " farWall { type fixedValue; value uniform (0 0 0); }\n sides { type slip; }\n}\n",
    })
    write_polymesh_of(case)
    return case


# ---------------------------------------------------------------------------
# the domain-decomposed flow solve (tests/test_torch_flowshard*.py)
# ---------------------------------------------------------------------------

PITZ_BMD = os.path.join(PITZ, "system", "blockMeshDict")


def flowshard_duct(dst, nx=24, ny=4, nz=4) -> str:
    """tests/test_flowshard.py's duct (6 x 1 x 1 m; inlet, outlet, walls)
    as a blockMeshDict under ``dst``; returns its path."""
    path = os.path.join(str(dst), f"duct_{nx}_{ny}_{nz}", "blockMeshDict")
    write_files(os.path.dirname(path), {"blockMeshDict": (
        _HDR % ("dictionary", "blockMeshDict") + "convertToMeters 1;\n"
        "vertices ( (0 0 0) (6 0 0) (6 1 0) (0 1 0) (0 0 1) (6 0 1) (6 1 1) (0 1 1) );\n"
        f"blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading (1 1 1) );\n"
        "boundary (\n inlet { type patch; faces ((0 4 7 3)); }\n"
        " outlet { type patch; faces ((1 2 6 5)); }\n"
        " walls { type wall; faces ((0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }\n);\n")})
    return path


def flowshard_meshes(dst) -> dict:
    """The duct (24 x 4 x 4, and 12 x 6 x 6 for the grids) and pitzDaily,
    each generated by both packages' blockMesh: {name: (port, JAX)}."""
    from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh
    from cudaparticlesfoam_tpu_torch.io import blockmesh

    paths = {"duct": flowshard_duct(dst), "duct6": flowshard_duct(dst, 12, 6, 6),
             "pitz": PITZ_BMD}
    return {name: (blockmesh.generate(p), jblockmesh.generate(p)) for name, p in paths.items()}


def duct_mrf(m, module, as_array, omega_z=6.0):
    """A rotor zone in the middle third of the flowshard duct rotating about
    z through its centre (tests/test_flowshard.py's ``_duct_mrf``), as
    ``module``'s MRFZones of ``as_array`` fields; ``m`` either package's
    FvMesh."""
    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    nf, n_int = m.n_faces, m.n_internal
    cc, own, nei = host(m.cc), host(m.owner), host(m.neighbour)
    in_zone = (cc[:, 0] > 2.0) & (cc[:, 0] < 4.0)
    origin, omega = np.array([3.0, 0.5, 0.5]), np.array([0.0, 0.0, omega_z])
    face_om, face_or = np.zeros((nf, 3)), np.zeros((nf, 3))
    f_int = in_zone[own[:n_int]] & in_zone[nei]
    face_om[:n_int][f_int], face_or[:n_int][f_int] = omega, origin
    f_bd = in_zone[own[n_int:]]
    face_om[n_int:][f_bd], face_or[n_int:][f_bd] = omega, origin
    return module.MRFZones(cell_omega=as_array(np.where(in_zone[:, None], omega, 0.0)),
                           cell_origin=as_array(np.where(in_zone[:, None], origin, 0.0)),
                           face_omega=as_array(face_om), face_origin=as_array(face_or))
