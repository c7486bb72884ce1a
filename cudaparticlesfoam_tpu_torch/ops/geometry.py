"""Tet geometry the steppers share (port of the part of
``cudaparticlesfoam_tpu/ops/geometry.py`` the engines need)."""

from __future__ import annotations

import torch


def bary_from_tinv(p, a, tinv):
    """Barycentric weights [n, 4] (wA, wB, wC, wD) of points ``p`` [n, 3]
    from the per-tet origin ``a`` [n, 3] and inverse edge matrix ``tinv``
    [n, 3, 3]: one 3x3 matvec, associated as the JAX package's
    ``bary_from_tinv`` sums it (left to right)."""
    rel = p - a
    wbcd = (tinv[:, :, 0] * rel[:, None, 0] + tinv[:, :, 1] * rel[:, None, 1]
            + tinv[:, :, 2] * rel[:, None, 2])
    wa = 1.0 - ((wbcd[:, 0] + wbcd[:, 1]) + wbcd[:, 2])
    return torch.cat([wa[:, None], wbcd], dim=1)
