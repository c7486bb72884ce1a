"""Generate tests/golden/torch_port_box_inputs.npz: the inputs of the
golden box anchors (tests/test_golden.py's ``box_setup``) in plain numpy,
so the PyTorch port can replay ``box_bary_adv``, ``box_bary_brownian`` and
``box_convex_adv`` (the same seeds and field, no noise) on a machine
without jax:

* ``seed_pos`` [256, 3] f64 and ``seed_tet`` [256] int32 — the threefry
  seeds of ``seed_in_box(256, 0.5, 5.5)`` and their located tets;
* ``tet_vel`` [1296, 3] f64 — the outward field ``1.5 * unit(centroid - 3)``;
* ``noise`` [60, 256, 3] f64 — the per-step Brownian normals
  ``jax.random.normal(fold_in(PRNGKey(0), step), (256, 3))``, steps 0..59.

It also writes tests/golden/torch_port_pitz_noise.npz, what the pitzDaily
driver anchor (``pitz_pos``, ``pitz_tet``, ``pitz_active`` of
tests/golden/particles_f64.npz, from tests/test_golden.py's shrunk
tutorial: 200 particles, 100 sub-steps, rngSeed 0) needs besides the
repo's own tutorial to run without jax:

* ``noise`` [100, 200, 3] f64 — the cached engine's per-step Brownian
  normals ``jax.random.normal(fold_in(PRNGKey(0), step), (200, 3))``,
  steps 0..99 (the warm-up advect draws none).

Run it with JAX on the CPU, then review the diff:

    JAX_PLATFORMS=cpu python tools/make_torch_port_inputs.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "golden")
OUT = os.path.join(GOLDEN_DIR, "torch_port_box_inputs.npz")
OUT_PITZ = os.path.join(GOLDEN_DIR, "torch_port_pitz_noise.npz")
N_CYCLES = 60
PITZ_PARTICLES, PITZ_CYCLES, PITZ_SEED = 200, 100, 0


def make_inputs() -> dict:
    """The fixture's arrays (needs jax with x64 enabled on the CPU)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from cudaparticlesfoam_tpu import (
        box_mesh, build_grid_locator, locate_seeds, seed_in_box,
    )

    mesh = box_mesh(6, 6, 6, dtype=np.float64)
    loc = build_grid_locator(mesh)
    pts = np.asarray(mesh.points, dtype=np.float64)
    cen = pts[np.asarray(mesh.tets)].mean(axis=1)
    outward = cen - 3.0
    outward /= np.linalg.norm(outward, axis=1, keepdims=True) + 1e-12
    st = seed_in_box(256, (0.5,) * 3, (5.5,) * 3, method="threefry")
    tet = locate_seeds(mesh, loc, st.pos)
    noise = np.stack([
        np.asarray(jax.random.normal(
            jax.random.fold_in(st.rng_key, step), (256, 3), dtype=np.float64))
        for step in range(N_CYCLES)
    ])
    return {
        "seed_pos": np.asarray(st.pos, dtype=np.float64),
        "seed_tet": np.asarray(tet, dtype=np.int32),
        "tet_vel": outward * 1.5,
        "noise": noise,
    }


def make_pitz_noise() -> dict:
    """The pitz driver anchor's noise (needs jax with x64 enabled on the
    CPU): the draws of the JAX cached engine, ``fused._brownian_noise`` in
    threefry mode, for the anchor's lane count (a multiple of the engine's
    8-lane block, so it draws for exactly these lanes)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    key = jax.random.PRNGKey(PITZ_SEED)
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, step), (PITZ_PARTICLES, 3),
                                     dtype=np.float64))
        for step in range(PITZ_CYCLES)
    ])
    return {"noise": noise}


def main():
    for path, data in ((OUT, make_inputs()), (OUT_PITZ, make_pitz_noise())):
        np.savez_compressed(path, **data)
        print(f"wrote {os.path.normpath(path)} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
