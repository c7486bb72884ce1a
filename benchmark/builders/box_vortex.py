"""Inputs of a box configuration: the box of unit hexes, each split into six
tets, the confined vortex as one velocity per tet, and the particles'
start positions drawn from the seed on the device.

The vortex turns about the box's z axis with tangential speed
omega r (1 - (r/R)^2), R half the box's side, so that the particles cross
tets all the time and the walls see only the Brownian kicks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    points: np.ndarray     # [nv, 3] float64
    tets: np.ndarray       # [nt, 4] int64
    tet_vel: np.ndarray    # [nt, 3] float64
    pos: torch.Tensor      # [n, 3] start positions, in the configuration's dtype


def box_points_tets(n: int):
    """Points and tets of the n x n x n box (the split of ``HostTetMesh.h``)."""
    xs = np.arange(n + 1, dtype=np.float64)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    iz, iy, ix = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    v0 = (iz * (n + 1) * (n + 1) + iy * (n + 1) + ix).ravel()
    v1 = v0 + 1
    v2 = v0 + (n + 1)
    v3 = v1 + (n + 1)
    v4 = v0 + (n + 1) * (n + 1)
    v5 = v1 + (n + 1) * (n + 1)
    v6 = v2 + (n + 1) * (n + 1)
    v7 = v3 + (n + 1) * (n + 1)
    tets = np.stack([np.stack(v, axis=-1) for v in
                     ((v0, v1, v3, v7), (v0, v1, v7, v5), (v0, v5, v7, v4),
                      (v0, v3, v2, v7), (v0, v6, v4, v7), (v0, v2, v6, v7))],
                    axis=1).reshape(-1, 4)
    return points, tets


def vortex(cen: np.ndarray, n: int, omega: float) -> np.ndarray:
    r = cen[:, :2] - n / 2.0
    r2 = (r * r).sum(axis=1) / (n / 2.0) ** 2
    w = (omega / n) * np.maximum(1.0 - r2, 0.0)
    u = np.zeros_like(cen)
    u[:, 0] = -r[:, 1] * w
    u[:, 1] = r[:, 0] * w
    return u


def dtype_of(config: dict) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


def build(config: dict, seed: int, device) -> Inputs:
    n = int(config["n_side"])
    points, tets = box_points_tets(n)
    tet_vel = vortex(points[tets].mean(axis=1), n, float(config["vortex_omega"]))
    lo, hi = (float(f) * n for f in config["seed_box_fraction"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand((int(config["n_particles"]), 3), generator=g, dtype=torch.float64,
                   device=device)
    pos = (lo + (hi - lo) * u).to(dtype_of(config))
    return Inputs(points=points, tets=tets, tet_vel=tet_vel, pos=pos)
