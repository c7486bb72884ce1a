"""PyTorch port: the device policy.  Every builder defaults to the card
(``dtypes.canonical_device``); without a usable CUDA it raises rather than
building on the CPU, and ``device="cpu"`` builds there.  ``run_cycles``
takes its device from the state's tensors."""

import numpy as np
import pytest
import torch

import cudaparticlesfoam_tpu_torch as cpt
from cudaparticlesfoam_tpu_torch import convert, dtypes
from cudaparticlesfoam_tpu_torch import mesh as tmesh

from torch_port_common import CPU   # also caps torch at one thread


def _payload():
    pts, tets, vv = tmesh.box_points_tets(2, 2, 2)
    return tmesh.from_arrays_host(pts, tets, tet_vel=vv[tets].mean(axis=1), vert_vel=vv)


def _seed_file(tmp_path):
    path = tmp_path / "seeds"
    path.write_text("positions 3\n// x y z\n0.5 0.5 0.5\n1.5 0.5 0.5\n0.5 1.5 1.5\n")
    return str(path)


# each builder with its arguments; kw is where the device goes
BUILDERS = {
    "box_mesh": lambda tmp, **kw: cpt.box_mesh(2, 2, 2, **kw).tet_row,
    "from_arrays": lambda tmp, **kw: tmesh.from_arrays(*tmesh.box_points_tets(1, 1, 1)[:2],
                                                       **kw).tet_row,
    "to_mesh": lambda tmp, **kw: convert.to_mesh(_payload(), **kw).tet_row,
    "host_to_device": lambda tmp, **kw: tmesh.host_to_device(_payload(), **kw).tet_row,
    "to_state": lambda tmp, **kw: convert.to_state(np.full((4, 3), 0.5), np.zeros(4, np.int32),
                                                   **kw).pos,
    "make_state": lambda tmp, **kw: cpt.make_state(np.full((4, 3), 0.5), **kw).pos,
    "seed_in_box": lambda tmp, **kw: cpt.seed_in_box(8, (0.1,) * 3, (1.9,) * 3, **kw).pos,
    "seed_from_file": lambda tmp, **kw: cpt.seed_from_file(_seed_file(tmp), **kw).pos,
}


def test_canonical_device_defaults_to_the_card():
    assert dtypes.canonical_device(None) == torch.device("cuda")
    assert dtypes.canonical_device("cpu") == CPU
    assert dtypes.canonical_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_without_a_device_goes_to_the_card_or_raises(name, tmp_path):
    build = BUILDERS[name]
    if torch.cuda.is_available():
        assert build(tmp_path).device.type == "cuda"
    else:
        # a CPU-only torch cannot allocate there, and nothing falls back to the CPU
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build(tmp_path)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_with_device_cpu_builds_on_the_cpu(name, tmp_path):
    assert BUILDERS[name](tmp_path, device=CPU).device == CPU
    assert BUILDERS[name](tmp_path, device="cpu").device == CPU


def test_run_cycles_follows_the_state_device():
    mesh = cpt.box_mesh(3, 3, 3, device=CPU)
    st = cpt.seed_in_box(64, (0.2,) * 3, (2.8,) * 3, device=CPU)
    st = convert.to_state(st.pos.numpy(), cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh),
                                                             st.pos).numpy(), device=CPU)
    out = cpt.run_cycles(mesh, st, cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3), 3)
    assert out.pos.device == CPU and out.tet_id.device == CPU and out.step == 3
    assert bool((out.tet_id >= 0).all())
