"""Particle checkpoint / restore (port of ``cudaparticlesfoam_tpu/io/checkpoint.py``).

The reference never checkpoints particle state (SURVEY.md §5): VTU output
is write-only, and the particle-file reader (``particles.cu:127-160``) has
no in-loop writer.  Here checkpoint/resume is first-class:

* :func:`save` / :func:`load` — the whole :class:`ParticleState` and run
  metadata as one ``.npz`` (portable, no framework dependency).  The port
  keys its noise by ``(seed, step)`` (``state.py``), not by a threefry key,
  so the file carries ``seed`` and ``step``, and a run resumed from it
  reproduces the uninterrupted run exactly.
* the ascii seed-file format round-trips via
  :func:`cudaparticlesfoam_tpu_torch.state.save_particle_file` /
  :func:`~cudaparticlesfoam_tpu_torch.state.seed_from_file` (reference
  format).

The JAX package's orbax backend (``save_orbax`` / ``load_orbax``) is
JAX-only and has no counterpart here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..dtypes import canonical_device
from ..state import ParticleState

_FIELDS = ("pos", "vel", "disp", "tet_id", "active")


def save(path: str, state: ParticleState, meta: dict | None = None) -> str:
    """Write the state (+ JSON-serialisable metadata) to an .npz file."""
    arrays = {k: getattr(state, k).detach().cpu().numpy() for k in _FIELDS}
    arrays["seed"] = np.asarray(state.seed, dtype=np.int64)
    arrays["step"] = np.asarray(state.step, dtype=np.int64)
    arrays["_meta"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load(path: str, device=None) -> tuple[ParticleState, dict]:
    """(state on ``device``, default the card; metadata) of a :func:`save` file."""
    dev = canonical_device(device)
    z = np.load(path)
    meta = json.loads(bytes(z["_meta"]).decode()) if "_meta" in z else {}
    tensors = {k: torch.from_numpy(np.array(z[k])).to(dev) for k in _FIELDS}
    return ParticleState(**tensors, seed=int(z["seed"]), step=int(z["step"])), meta
