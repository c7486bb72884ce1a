"""The plain references agree with the port's CPU paths at a tiny size: a
4 x 4 x 4 box of tracers, and the flow of the TJunction shrunk to 1,984
cells."""

import os

import numpy as np
import torch

from harness import spec
from reference import particles as ref


def test_particles_reference_equals_the_port():
    import cudaparticlesfoam_tpu_torch as cpt

    build = spec.load_module("builders", "box_vortex").build

    cfg = {"n_side": 4, "n_particles": 400, "vortex_omega": 5.2, "seed_box_fraction": [0.05, 0.95],
           "dtype": "float32"}
    inp = build(cfg, 2**31 + 7, "cpu")
    mesh = cpt.from_arrays(inp.points, inp.tets, tet_vel=inp.tet_vel, device="cpu")
    tab, bd = ref.build_table(inp.points, inp.tets, inp.tet_vel)
    assert torch.equal(tab, mesh.tet_row)
    tet = cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh), inp.pos)
    assert torch.equal(ref.locate(tab, inp.points, inp.tets, inp.pos), tet)
    st = cpt.make_state(inp.pos, tet_id=tet, rng_seed=99, device="cpu")
    cfg_p = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3)
    out = cpt.run_cycles(mesh, st, cfg_p, 30)
    pos, vel, tet_r, act = ref.run(tab, bd, inp.pos, st.vel, tet, st.active, seed=99, step=0,
                                   n_cycles=30, dt=0.3, diffusion_coeff=5e-3, n_hops=1,
                                   bounce_on=True)
    assert int((out.tet_id != st.tet_id).sum()) > 0
    assert torch.equal(pos, out.pos) and torch.equal(tet_r, out.tet_id)
    assert torch.equal(vel, out.vel) and torch.equal(act, out.active)


def test_flow_reference_equals_the_port(small_tjunction):
    flow = spec.load_module("drivers", "flow")
    fields_of, program_stepper = flow.fields_of, flow.program_stepper
    reference_stepper = flow.reference_stepper
    case_dir = spec.load_module("builders", "foam_case").prepare(small_tjunction().config)

    class Ctx:
        device = "cpu"

        @staticmethod
        def program():
            import cudaparticlesfoam_tpu_torch
            return cudaparticlesfoam_tpu_torch

    prog = program_stepper(Ctx, case_dir, torch.float32)
    refs = reference_stepper(case_dir, torch.float32, "cpu")
    for _ in range(3):
        assert prog.step() == refs.step()
    a, b = fields_of(prog.flow), fields_of(refs.flow)
    assert set(a) == {"U", "p", "phi", "k", "epsilon"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert float(a["U"].abs().max()) > 0
    assert not os.path.exists(os.path.join(case_dir, "constant", "polyMesh", "points"))
    assert np.isfinite(float(a["p"].abs().max()))
