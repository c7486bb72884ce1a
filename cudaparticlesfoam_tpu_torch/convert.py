"""Carry state from the JAX package (or any numpy source) into the port.

Both packages take a mesh as the same numpy payload (``from_arrays_host``),
so a parity check builds one payload and uploads it to each.  Nothing here
imports jax: a JAX ``TetMesh`` is passed in as ``mesh_payload(jax_mesh)``,
which only reads its fields through ``numpy.asarray``.  The flow solvers'
objects (``FvMesh``, ``BoundaryCoeffs``, ``FlowState``, the turbulence
states, ``WallInfo``, ``AmgHierarchy``) come across the same way: each
``to_*`` reads the fields of the object it is given with
``numpy.asarray``, so a JAX object, or anything with those attributes,
starts the port from the same values (floats keep their dtype, index
tables become int64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dtypes import canonical_device
from .mesh import ARRAY_FIELDS, META_FIELDS, OPTIONAL_FIELDS, TetMesh, host_to_device
from .models import fv, simple, turbulence
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


def _tensor(x, device, index=False):
    if x is None:
        return None
    arr = np.array(x)
    return torch.as_tensor(arr.astype(np.int64) if index else arr, device=device)


def _fields(obj, cls, device, index=(), meta=()):
    """``cls`` built from ``obj``'s attributes: the array fields on
    ``device`` (the ``index`` ones as int64), the ``meta`` ones as they are."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name, None)
        if f.name in meta:
            kw[f.name] = v
        elif isinstance(v, (tuple, list)):
            kw[f.name] = tuple(_tensor(x, device, f.name in index) for x in v)
        else:
            kw[f.name] = _tensor(v, device, f.name in index)
    return cls(**kw)


def to_fv_mesh(m_like, device=None) -> fv.FvMesh:
    """The port's :class:`~.models.fv.FvMesh` of an object with its fields
    (a JAX ``FvMesh``) on ``device`` (default the card)."""
    m = _fields(m_like, fv.FvMesh, canonical_device(device), index=("owner", "neighbour"),
                meta=("n_cells", "n_faces", "n_internal", "patch_slices"))
    return dataclasses.replace(
        m, n_cells=int(m.n_cells), n_faces=int(m.n_faces), n_internal=int(m.n_internal),
        patch_slices=tuple((str(n), str(t), int(s), int(c))
                           for n, t, s, c in m_like.patch_slices))


def to_bcs(bc_like, device=None) -> fv.BoundaryCoeffs:
    return _fields(bc_like, fv.BoundaryCoeffs, canonical_device(device))


def to_flow_state(st_like, device=None) -> simple.FlowState:
    return _fields(st_like, simple.FlowState, canonical_device(device))


def to_turbulence_state(st_like, device=None):
    """:class:`KOmegaSSTState` where the object has ``omega``, else
    :class:`KEpsilonState`."""
    cls = (turbulence.KOmegaSSTState if hasattr(st_like, "omega")
           else turbulence.KEpsilonState)
    return _fields(st_like, cls, canonical_device(device))


def to_wall_info(wi_like, device=None) -> turbulence.WallInfo:
    return _fields(wi_like, turbulence.WallInfo, canonical_device(device),
                   index=("wall_cell", "wall_bd_face"))


def to_amg(h_like, device=None) -> fv.AmgHierarchy:
    h = _fields(h_like, fv.AmgHierarchy, canonical_device(device),
                index=("aggs", "owners", "neighs", "f2cf"), meta=("sizes",))
    return dataclasses.replace(h, sizes=tuple(int(x) for x in h_like.sizes))
