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
