"""Carry state from the JAX package (or any numpy source) into the port.

Both packages take a mesh as the same numpy payload (``from_arrays_host``),
so a parity check builds one payload and uploads it to each.  Nothing here
imports jax: a JAX ``TetMesh`` is passed in as ``mesh_payload(jax_mesh)``,
which only reads its fields through ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import ARRAY_FIELDS, META_FIELDS, OPTIONAL_FIELDS, TetMesh, host_to_device
from .state import ParticleState, make_state


def mesh_payload(mesh_like) -> dict:
    """numpy payload of any object with the mesh fields as attributes (a
    JAX ``TetMesh``, or the port's own), with the convex and
    VertexVelocity row tables where the object carries them; the JAX
    package's ``host_to_device`` takes the same dict."""
    out = {k: np.asarray(getattr(mesh_like, k)) for k in ARRAY_FIELDS}
    for k in OPTIONAL_FIELDS:
        if getattr(mesh_like, k, None) is not None:
            out[k] = np.asarray(getattr(mesh_like, k))
    out.update({k: int(getattr(mesh_like, k)) for k in META_FIELDS})
    return out


def to_mesh(payload: dict, device=None) -> TetMesh:
    """The port's :class:`TetMesh` of a payload dict on ``device``
    (default the card; ``"cpu"`` for the plain versions)."""
    return host_to_device(payload, device)


def to_state(pos, tet_id, vel=None, active=None, seed: int = 0, step: int = 0,
             dtype=None, device=None) -> ParticleState:
    """The port's :class:`ParticleState` from array-likes (numpy, or JAX
    arrays, copied through ``numpy.array``) on ``device`` (default the
    card, as :func:`state.make_state`)."""
    st = make_state(np.array(pos), tet_id=np.array(tet_id), rng_seed=seed,
                    dtype=dtype, device=device)
    kw = {"step": int(step)}
    if vel is not None:
        kw["vel"] = torch.as_tensor(np.array(vel), dtype=st.dtype, device=st.device)
    if active is not None:
        kw["active"] = torch.as_tensor(np.array(active), dtype=torch.bool,
                                       device=st.device)
    return dataclasses.replace(st, **kw)
