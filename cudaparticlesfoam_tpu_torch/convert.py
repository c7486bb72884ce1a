"""Carry state from the JAX package (or any numpy source) into the port.

Both packages take a mesh as the same numpy payload (``from_arrays_host``),
so a parity check builds one payload and uploads it to each.  Nothing here
imports jax: a JAX ``TetMesh`` is passed in as ``mesh_payload(jax_mesh)``,
which only reads its fields through ``numpy.asarray``.  The flow solvers'
objects (``FvMesh``, ``BoundaryCoeffs``, ``FlowState``, the turbulence
states, ``WallInfo``, ``AmgHierarchy``, ``MRFZones``, ``FvOptions`` with
its ``grad_p`` / ``dgrad`` state, and a ``DynamicMesh`` with its motion
and the geometry it carries from step to step) come across the same way: each
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
from .models import dynamicmesh, fv, fvoptions, motionsolver, mrf, simple, turbulence
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


def to_mrf(z_like, device=None) -> mrf.MRFZones:
    return _fields(z_like, mrf.MRFZones, canonical_device(device))


def to_fvoptions(fvo_like, device=None) -> fvoptions.FvOptions:
    """The port's :class:`~.models.fvoptions.FvOptions`, the controller's
    state (``grad_p``, ``dgrad``) included."""
    out = _fields(fvo_like, fvoptions.FvOptions, canonical_device(device), meta=("has_mvf",))
    return dataclasses.replace(out, has_mvf=bool(fvo_like.has_mvf))


def to_motion(motion_like):
    """The port's motion description (solid body, multi solid body or
    Laplacian motion solver) of an object with the same fields."""
    name = type(motion_like).__name__
    if name == "MultiSolidBodyMotion":
        return dynamicmesh.MultiSolidBodyMotion(
            zones=tuple((str(z), to_motion(sb)) for z, sb in motion_like.zones))
    if name == "MotionSolverMotion":
        return motionsolver.MotionSolverMotion(
            kind=motion_like.kind, component=motion_like.component,
            diffusivity=motion_like.diffusivity,
            bcs=tuple((str(p), motionsolver.PointBC(b.btype, tuple(b.value), b.omega))
                      for p, b in motion_like.bcs))
    return dynamicmesh.SolidBodyMotion(**{f.name: getattr(motion_like, f.name)
                                          for f in dataclasses.fields(
                                              dynamicmesh.SolidBodyMotion)})


def to_dynamic_mesh(dm_like, pm, dtype=None, device=None) -> dynamicmesh.DynamicMesh:
    """The port's :class:`~.models.dynamicmesh.DynamicMesh` on ``pm`` (a
    port PolyMesh whose points are the other object's current points) with
    the other object's motion, initial points and the state it carries
    between steps: the previous face centres and areas, and a Laplacian
    solver's current points and cached cell diffusivity."""
    dm = dynamicmesh.DynamicMesh(to_motion(dm_like.motion), pm, dtype=dtype, device=device)
    dm.points0 = np.array(dm_like.points0, dtype=np.float64)
    if dm_like._cf_old is not None:
        dm._cf_old = tuple(np.array(x, dtype=np.float64) for x in dm_like._cf_old)
    if dm_like._lap is not None:
        dm._lap.points0 = np.array(dm_like._lap.points0, dtype=np.float64)
        dm._lap._pts = np.array(dm_like._lap._pts, dtype=np.float64)
        if dm_like._lap._gamma_cells is not None:
            dm._lap._gamma_cells = np.array(dm_like._lap._gamma_cells, dtype=np.float64)
    return dm


def to_partitioned_mesh(pm_like, device=None):
    """The port's ``parallel.partition.PartitionedMesh`` of an object with
    the JAX ``PartitionedMesh``'s fields ([S, per, w] rows, [S, per, 4]
    codes, the permutations, ``bd_escape``), every shard on ``device``
    (default the card).  JAX's 29-column Pk rows are padded to the port's
    32 (the kernels' ``tet_row_pk32`` layout, codes at 24:28)."""
    from .parallel import partition

    dev = canonical_device(device)
    rows = np.array(pm_like.tet_row)
    layout = {20: "tet", 29: "pk", 24: "cx"}[rows.shape[-1]]
    if layout == "pk":
        rows = np.concatenate([rows, np.zeros(rows.shape[:2] + (3,), rows.dtype)], axis=2)
    S = int(pm_like.n_shards)
    esc = torch.as_tensor(np.array(pm_like.bd_escape), device=dev)
    return partition.PartitionedMesh(
        tet_row=[torch.as_tensor(r, device=dev) for r in rows],
        tet_nbr=[torch.as_tensor(r.astype(np.int32), device=dev)
                 for r in np.array(pm_like.tet_nbr)],
        perm=torch.as_tensor(np.array(pm_like.perm).astype(np.int64), device=dev),
        inv_perm=torch.as_tensor(np.array(pm_like.inv_perm).astype(np.int64), device=dev),
        bd_escape=[esc] * S, n_shards=S, tets_per_shard=int(pm_like.tets_per_shard),
        n_tets=int(pm_like.n_tets), layout=layout)


def to_sharded_particles(sp_like, seed=None, device=None):
    """The port's ``parallel.partition.ShardedParticles`` of an object with
    the JAX ``ShardedParticles``' fields ([S, C, ...] slots), on ``device``
    (default the card).  ``seed`` defaults to the one of the JAX key
    (``PRNGKey(seed)`` = (seed >> 32, seed & 0xffffffff))."""
    from .parallel import partition

    dev = canonical_device(device)
    if seed is None:
        k = np.array(sp_like.rng_key).astype(np.uint64).reshape(-1)
        seed = int(k[0]) << 32 | int(k[1])

    def split(x, dtype=None):
        a = np.array(x)
        return [torch.as_tensor(r if dtype is None else r.astype(dtype), device=dev) for r in a]

    return partition.ShardedParticles(
        pos=split(sp_like.pos), vel=split(sp_like.vel), disp=split(sp_like.disp),
        tet=split(sp_like.tet, np.int32), active=split(sp_like.active),
        resident=split(sp_like.resident), pid=split(sp_like.pid, np.int32), seed=int(seed),
        step=int(np.array(sp_like.step)), n_shards=int(sp_like.n_shards),
        capacity=int(sp_like.capacity))


def to_sharded_flow_mesh(smesh_like, devices=None, device=None):
    """The port's ``parallel.flowshard.ShardedFlowMesh`` of an object with
    the JAX ``ShardedFlowMesh``'s fields (stacked [D, ...] arrays, its
    ``n_loc``, ``fv_meta`` and ``halo_perms``), shard s on ``devices[s]``
    (default ``make_device_mesh(D, device)``: the card unless ``device``
    says otherwise), so that both packages run one decomposition."""
    from .parallel import flowshard, sharding

    arrs = {k: np.array(getattr(smesh_like, k)) for k in flowshard.HOST_FIELDS}
    for k in ("owner", "neighbour", "send", "glob_cell", "fglob"):
        arrs[k] = arrs[k].astype(np.int64)
    n_dev = int(smesh_like.n_dev)
    c_ext, n_faces, n_int, patch_slices = smesh_like.fv_meta
    halo_perms = tuple(tuple((int(a), int(b)) for a, b in r) for r in smesh_like.halo_perms)
    if devices is None:
        devices = sharding.make_device_mesh(n_dev, device)
    return flowshard.make_sharded_flow_mesh(
        arrs, n_dev, int(smesh_like.n_loc), (int(c_ext), int(n_faces), int(n_int),
                                             tuple(patch_slices)), halo_perms, devices)


def to_local_amg(lamg_like, smesh):
    """The port's ``parallel.flowshard.LocalAmg`` of an object with the JAX
    ``LocalAmg``'s fields, its shard tensors on ``smesh``'s devices."""
    from .parallel import flowshard

    idx = lambda xs: [np.array(x).astype(np.int64) for x in xs]  # noqa: E731
    return flowshard.make_local_amg({
        "aggs": idx(lamg_like.aggs), "owners": idx(lamg_like.owners),
        "neighs": idx(lamg_like.neighs), "f2cf": idx(lamg_like.f2cf),
        "off_mask": np.array(lamg_like.off_mask),
        "sizes": [(int(a), int(b)) for a, b in lamg_like.sizes],
        "n_levels": int(lamg_like.n_levels)}, smesh)
