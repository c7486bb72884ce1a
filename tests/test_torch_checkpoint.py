"""PyTorch port: particle checkpoint / resume (``io/checkpoint.py``), the
twin of tests/test_aux.py::test_checkpoint_roundtrip_and_resume on the
CPU.  The port keys its noise by (seed, step), so a run resumed from the
file reproduces the uninterrupted run bit for bit."""

from torch_port_common import CPU

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cudaparticlesfoam_tpu_torch as cpt  # noqa: E402
from cudaparticlesfoam_tpu_torch.io import checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def box():
    return cpt.box_mesh(4, 4, 4, dtype=np.float64, device=CPU)


def seeded(box, n=64, seed=0):
    pos = np.random.default_rng(seed).uniform(0.5, 3.5, (n, 3))
    tet = cpt.locate_seeds(box, cpt.build_grid_locator(box), torch.as_tensor(pos))
    return cpt.make_state(pos, tet_id=tet, rng_seed=seed, dtype=np.float64, device=CPU)


@pytest.mark.parametrize("engine", ["cached", "simple"])
def test_checkpoint_roundtrip_and_resume(tmp_path, box, engine):
    st = seeded(box, seed=3)
    cfg = cpt.StepConfig(dt=0.01, diffusion_coeff=1e-4, engine=engine)
    mid = cpt.run_cycles(box, st, cfg, 5)
    path = checkpoint.save(str(tmp_path / "ck" / "ck.npz"), mid, meta={"t": 1.5})
    back, meta = checkpoint.load(path, device=CPU)
    assert meta["t"] == 1.5
    for k in ("pos", "vel", "disp", "tet_id", "active"):
        got, want = getattr(back, k), getattr(mid, k)
        assert got.dtype == want.dtype and torch.equal(got, want), k
    assert back.seed == 3 and back.step == 5
    # resuming reproduces the uninterrupted run exactly (noise keyed by step)
    full = cpt.run_cycles(box, st, cfg, 10)
    resumed = cpt.run_cycles(box, back, cfg, 5)
    assert torch.equal(resumed.pos, full.pos) and torch.equal(resumed.tet_id, full.tet_id)
    assert resumed.step == full.step == 10


def test_checkpoint_load_defaults_to_the_card(tmp_path, box):
    path = checkpoint.save(str(tmp_path / "ck.npz"), seeded(box, n=8))
    if torch.cuda.is_available():
        assert checkpoint.load(path)[0].pos.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        checkpoint.load(path)
