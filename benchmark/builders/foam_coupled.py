"""Inputs of a coupled OpenFOAM case configuration: the case copied as
:mod:`builders.foam_case` copies it, with the particles' window opened at
the configuration's ``particles_start_time`` (cudaParticlesDict's
``startTime``), and the particles' start positions, uniform in the
configuration's ``seeding_box``, drawn from the seed on the device.
"""

from __future__ import annotations

import os
import re

import torch

from harness import spec

_START = re.compile(r"^(\s*startTime\s+)[^;]*;", re.MULTILINE)


def prepare(config: dict) -> str:
    """The case directory of ``config``, its particle window opened at
    ``particles_start_time``."""
    case = spec.load_module("builders", "foam_case").prepare(config)
    path = os.path.join(case, "system", "cudaParticlesDict")
    with open(path) as fh:
        text = fh.read()
    new = _START.sub(lambda m: f"{m.group(1)}{config['particles_start_time']!r};", text, count=1)
    if new != text:
        with open(path, "w") as fh:
            fh.write(new)
    return case


def positions(config: dict, seed: int, device) -> torch.Tensor:
    """``n_particles`` start positions, uniform in ``seeding_box``, in the
    particles' dtype."""
    lo, hi = (torch.tensor(c, dtype=torch.float64, device=device)
              for c in config["seeding_box"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand((int(config["n_particles"]), 3), generator=g, dtype=torch.float64,
                   device=device)
    dtype = {"float32": torch.float32, "float64": torch.float64}[config["particle_dtype"]]
    return (lo + (hi - lo) * u).to(dtype)
