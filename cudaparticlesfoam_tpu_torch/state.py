"""Particle state and seeding (PyTorch port of
``cudaparticlesfoam_tpu/state.py``).

The JAX package carries a threefry key; the port carries an integer
``seed`` and the completed sub-step count ``step``, from which each cycle
seeds its own ``torch.Generator`` (see ``ops.fused._brownian_noise``).
Injection (:func:`inject`, :func:`inject_device`) draws its uniforms the
same way (:func:`_inject_uniforms`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dtypes import canonical_device, canonical_float


@dataclasses.dataclass(frozen=True, eq=False)
class ParticleState:
    pos: torch.Tensor      # [n, 3] float
    vel: torch.Tensor      # [n, 3] float      (d_particle_vels)
    disp: torch.Tensor     # [n, 3] float      (zeroed after move)
    tet_id: torch.Tensor   # [n] int32         (negative = out / wall-hit code)
    active: torch.Tensor   # [n] bool
    seed: int              # noise seed
    step: int              # completed Lagrangian sub-steps

    @property
    def n_particles(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device


def make_state(pos, tet_id=None, rng_seed: int = 0, dtype=None,
               device=None) -> ParticleState:
    """A state of the given positions (tet -1 = not located yet, zero
    velocity, all active) on ``device``: default the card
    (``dtypes.canonical_device``), ``"cpu"`` for the plain versions."""
    fdt = canonical_float(dtype)
    dev = canonical_device(device)
    pos = torch.as_tensor(pos, dtype=fdt, device=dev)
    n = pos.shape[0]
    if tet_id is None:
        tet = torch.full((n,), -1, dtype=torch.int32, device=dev)
    else:
        tet = torch.as_tensor(tet_id, dtype=torch.int32, device=dev)
    return ParticleState(
        pos=pos,
        vel=torch.zeros((n, 3), dtype=fdt, device=dev),
        disp=torch.zeros((n, 3), dtype=fdt, device=dev),
        tet_id=tet,
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        seed=int(rng_seed),
        step=0,
    )


def _owl_lcg_uniform3(n: int) -> np.ndarray:
    """Bit-exact reproduction of the reference's in-box seeding RNG: owl's
    24-bit LCG after a 16-round TEA scramble of (i % 128, i / 128)
    (``cuda/particles.cu:78-97``, ``owl/common/math/random.h:57-91``),
    x, y, z drawn as ``float(state) * 2^-32``."""
    i = np.arange(n, dtype=np.uint32)
    v0 = i % np.uint32(128)
    v1 = i // np.uint32(128)
    s0 = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(16):
            s0 = np.uint32(s0 + np.uint32(0x9E3779B9))
            v0 = v0 + (
                ((v1 << np.uint32(4)) + np.uint32(0xA341316C))
                ^ (v1 + s0)
                ^ ((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))
            )
            v1 = v1 + (
                ((v0 << np.uint32(4)) + np.uint32(0xAD90777D))
                ^ (v0 + s0)
                ^ ((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))
            )
        state = v0
        out = np.empty((n, 3), dtype=np.float64)
        lcg_a = np.uint32(1664525)
        lcg_c = np.uint32(1013904223)
        for axis in range(3):
            state = lcg_a * state + lcg_c
            # ldexpf(float(state), -32): f32 rounding of state, then * 2^-32
            out[:, axis] = state.astype(np.float32).astype(np.float64) * 2.0**-32
    return out


def seed_in_box(n: int, box_lo, box_hi, rng_seed: int = 0,
                method: str = "reference", dtype=None,
                device=None) -> ParticleState:
    """Uniform seeding inside a box (``initParticlesKernel``,
    ``particles.cu:78-108``).  ``method="reference"`` gives the CUDA
    build's owl-LCG positions bit for bit; ``"threefry"`` is the JAX
    package's jax.random stream, which cannot be reproduced without jax.
    The state lands on ``device`` (default the card, as :func:`make_state`)."""
    if method == "threefry":
        raise NotImplementedError(
            "seed_in_box(method='threefry') draws jax.random bits and needs "
            "jax; use method='reference' or pass positions to make_state"
        )
    if method != "reference":
        raise ValueError(f"unknown seeding method {method!r}")
    lo = np.asarray(box_lo, dtype=np.float64)
    hi = np.asarray(box_hi, dtype=np.float64)
    # lo/hi used as given (the reference does not re-sort an inverted box)
    pos = lo + _owl_lcg_uniform3(n) * (hi - lo)
    return make_state(pos, rng_seed=rng_seed, dtype=dtype, device=device)


def seed_from_file(path: str, n: int | None = None, rng_seed: int = 0,
                   dtype=None, device=None) -> ParticleState:
    """File seeding (``particles.cu:127-160``): header ``<word> N``, a
    comment line, then ``x y z [tetID]`` rows; a 4th column is the start
    tet, 3-column files get tet_id = -1 (caller locates).  On ``device``
    (default the card, as :func:`make_state`)."""
    with open(path) as fh:
        header = fh.readline().split()
        n_file = int(float(header[-1]))
        fh.readline()
        data = np.loadtxt(fh, max_rows=n_file)
    if data.ndim == 1:
        data = data[None, :]
    if n is None:
        n = n_file
    tet_id = data[:n, 3].astype(np.int32) if data.shape[1] >= 4 else None
    return make_state(data[:n, :3], tet_id=tet_id, rng_seed=rng_seed,
                      dtype=dtype, device=device)


def save_particle_file(path: str, state: ParticleState) -> None:
    """Writer for the seed-file format (round-trips with seed_from_file);
    the reference has the reader but no writer — this closes the
    checkpoint gap noted in SURVEY.md §5."""
    pos = state.pos.detach().cpu().numpy()
    tet = state.tet_id.detach().cpu().numpy()
    with open(path, "w") as fh:
        fh.write(f"NumParticles {len(pos)}\n")
        fh.write("x y z tetID\n")
        for p, t in zip(pos, tet):
            fh.write(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g} {int(t)}\n")


def _inject_uniforms(state: ParticleState, count: int, rng_seed: int) -> torch.Tensor:
    """[count, 3] uniforms in [0, 1) of an injection at ``state.step``: a
    ``torch.Generator`` on the state's device seeded from (seed, step +
    7919 + rng_seed), the stream the JAX package draws with
    ``jax.random.uniform(fold_in(key, step + 7919 + rng_seed))`` (whose bits
    torch cannot reproduce; parity tests feed both the same uniforms)."""
    from .ops.fused import _stream_seed

    g = torch.Generator(device=state.device)
    g.manual_seed(_stream_seed(state.seed, int(state.step) + 7919 + int(rng_seed),
                               state.device))
    return torch.rand((count, 3), generator=g, dtype=state.dtype, device=state.device)


def _box_points(state: ParticleState, u, box_lo, box_hi):
    lo = torch.as_tensor(box_lo, dtype=state.dtype, device=state.device)
    hi = torch.as_tensor(box_hi, dtype=state.dtype, device=state.device)
    return lo + u * (hi - lo)


def inject_device(state: ParticleState, mesh, locator, box_lo, box_hi, count: int,
                  rng_seed: int = 0) -> ParticleState:
    """:func:`inject` with no host synchronisation (JAX
    ``state.inject_device``): dead slots come from a sort of the lane ids
    (live lanes sorted last), seeds from the same uniform draw
    (:func:`_inject_uniforms`), location from the grid + walk
    ``ops.locate.first_locate`` (no brute-force fallback: unresolved seeds
    stay dead, like the host path's ``ok`` mask).  With >= ``count`` dead
    slots and a grid-resolvable box the result equals :func:`inject`'s."""
    from .ops import locate as locate_ops

    n = state.n_particles
    count = int(count)
    if count <= 0:
        return state
    new_pos = _box_points(state, _inject_uniforms(state, count, rng_seed), box_lo, box_hi)
    tet = locate_ops.first_locate(mesh, locator, new_pos)
    lane = torch.arange(n, dtype=torch.int64, device=state.device)
    slots = torch.sort(torch.where(state.active, n, lane)).values[:count]
    k = slots.shape[0]
    new_pos, tet = new_pos[:k], tet[:k]
    ok = (slots < n) & (tet >= 0)
    # slots == n (fewer dead lanes than count) are dropped, as JAX's mode="drop"
    live = slots < n
    sl, zeros3 = slots[live], torch.zeros((k, 3), dtype=state.dtype, device=state.device)

    def put(x, v):
        x = x.clone()
        x[sl] = v[live]
        return x

    return dataclasses.replace(
        state,
        pos=put(state.pos, new_pos),
        vel=put(state.vel, zeros3),
        disp=put(state.disp, zeros3),
        tet_id=put(state.tet_id, tet.to(torch.int32)),
        active=put(state.active, ok),
    )


def inject(state: ParticleState, mesh, locator, box_lo, box_hi, count: int,
           rng_seed: int = 0) -> tuple[ParticleState, int]:
    """Continuous injection with slot reuse (BASELINE.json config 4):
    re-seed up to ``count`` dead slots uniformly in the box, locate them,
    and reactivate.  Dead slots come from absorbing boundaries
    (escapePatches) or reflection-off runs.  Returns (state, n_injected).

    Host-ordered (runs between chunks of cycles, like VTU writes; one
    readback of the active flags); the reference has no injection
    machinery at all — particles only ever die (``particles.cu:262-266``).
    The uniforms are :func:`_inject_uniforms`'s."""
    from .ops import locate as locate_ops

    dead = torch.nonzero(~state.active).flatten()
    if dead.numel() == 0 or count <= 0:
        return state, 0
    slots = dead[:count]
    new_pos = _box_points(state, _inject_uniforms(state, slots.numel(), rng_seed),
                          box_lo, box_hi)
    tet = locate_ops.locate_seeds(mesh, locator, new_pos)
    ok = tet >= 0

    def put(x, v):
        x = x.clone()
        x[slots] = v
        return x

    return (
        dataclasses.replace(
            state, pos=put(state.pos, new_pos), vel=put(state.vel, 0.0),
            disp=put(state.disp, 0.0), tet_id=put(state.tet_id, tet.to(torch.int32)),
            active=put(state.active, ok)),
        int(ok.sum()),
    )
