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
