"""Domain-decomposed (sharded) incompressible flow solve (port of
``cudaparticlesfoam_tpu/parallel/flowshard.py``).

The answer to the reference's MPI fluid decomposition (``decomposePar``
with the ``simple``/``hierarchical`` method + ``mpirun -np 4
cudaParticlesPimpleFoam -parallel``, ``tutorials/.../TJunction/
Allrun-parallel:10-11``, ``TJunction/system/decomposeParDict:17-24``):
cells are split into coordinate-rank blocks over a (gx, gy, gz) grid of
shards (1-D slabs by default, the dict's ``n`` coefficient when present;
recursive coordinate bisection, the graph partitioner of
:mod:`.graphpart` or any explicit cell map), each shard owns one block plus
a one-cell ghost layer, and the PIMPLE step runs on every shard with

* a halo exchange, one directed round per device-id delta across the
  decomposition's faces, refreshing ghost-cell values before any operator
  that reads neighbour cells (:func:`halo_refresh`), and
* global sums and maxima over the shards (:func:`psum`, :func:`pmax`) for
  the CG dot products, residuals, continuity and the Courant number.

**One controller, an explicit shard axis** (as :mod:`.sharding`): JAX runs
the step as one ``shard_map`` program with ``lax.ppermute`` / ``lax.psum``
/ ``lax.pmax``.  Here shard ``s`` lives on ``devices[s]``
(:func:`.sharding.make_device_mesh`: more shards than cards share them in
turn, ``cuda:0 x4`` on one card; a CPU caller gets S shards on ``cpu``)
and the step is a Python loop over the shards in lockstep.  The three
collectives are the only code that talks across shards:

* ``halo_refresh(smesh, xs)``: round ``r`` copies ``xs[src][send[src][r]]``
  into ``xs[dst][n_loc + r*H : n_loc + (r+1)*H]`` for every static
  ``(src, dst)`` pair of ``halo_perms[r]`` (an index gather, a
  ``.to(devices[dst])`` that does nothing when the shards share a card,
  and one ``cat`` a receiving shard);
* ``psum(xs)`` adds the S per-shard partial sums on shard 0's device, in
  shard order; ``pmax`` takes their maximum.

The CG loops keep JAX's ``lax.while_loop`` semantics (the same exit test,
``max_iter`` and iteration counts) and read the exit test on the host once
per iteration for the whole solve, as ``models/fv._pcg`` does.

Construction reuses the single-device FV layer: each shard is a padded
local :class:`..models.fv.FvMesh` whose cross-partition faces point at
ghost-cell slots appended after the owned cells, so the face operators of
``models/fv.py`` (interpolation, surface sums, matrix assembly, matvec) run
unchanged; only the ghost refresh and the masked, summed reductions are
new.  :func:`decompose` returns the same stacked numpy arrays as JAX's
(array for array, ``tests/test_torch_flowshard.py``; its face loops are
vectorized over the faces in global order) and builds the per-shard
tensors from them.  Torch has no ``mode="drop"`` scatter: where JAX drops
padded indices out of range, the port scatters into one spare slot and
slices it off.

Torch ops on the shards' devices; there is no kernel here.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..dtypes import canonical_device, canonical_float, numpy_float
from ..models import fv
from ..models.pimple import correct as pimple_correct
from ..models.pimple import courant_dt, p_table_bcs
from ..models.simple import FlowState, _pressure_matrix
from ..ops import amg as amg_ops
from .sharding import make_device_mesh, on_device, placement

# the stacked arrays of a ShardedFlowMesh, named as JAX's fields
HOST_FIELDS = ("owner", "neighbour", "sf", "mag_sf", "cf", "cc", "vol", "w", "delta",
               "bd_delta", "nonortho", "send", "cell_mask", "glob_cell", "fglob")


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """Shard ``s``'s tensors on its device."""

    m: fv.FvMesh               # local mesh, ghosts included (patch_slices empty)
    mask: torch.Tensor         # [C_ext] bool: owned cells
    maskf: torch.Tensor        # [C_ext] the same in the flow dtype
    send: torch.Tensor         # [R, H] int64: local cells sent in each round
    device: torch.device
    # the gathers' maps, on shard 0's device: the owned cells' global ids,
    # and the local face slots with their global face ids and orientation
    glob0: torch.Tensor
    face_loc0: torch.Tensor
    face_gid0: torch.Tensor
    face_sign0: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedFlowMesh:
    """Stacked per-shard FV meshes + halo exchange plan.

    The array fields are numpy, leading with the shard axis [D, ...], equal
    to JAX's ``ShardedFlowMesh`` fields; ``shards`` holds each shard's
    tensors on ``devices[s]``.  ``fv_meta`` is (n_cells incl. ghosts,
    n_faces, n_internal, patch_slices) of every local mesh.  The ghost slot
    layout of a shard is [owned | recv_round0 | recv_round1 | ... | dummy];
    round r's exchange pairs are the static ``halo_perms[r]``."""

    owner: np.ndarray
    neighbour: np.ndarray
    sf: np.ndarray
    mag_sf: np.ndarray
    cf: np.ndarray
    cc: np.ndarray
    vol: np.ndarray
    w: np.ndarray
    delta: np.ndarray
    bd_delta: np.ndarray
    nonortho: np.ndarray
    send: np.ndarray          # [D, R, H]
    cell_mask: np.ndarray     # [D, C_ext] True on owned (non-ghost, non-pad)
    glob_cell: np.ndarray     # [D, C_ext] global cell id (or -1)
    fglob: np.ndarray         # [D, nf] signed global face id + 1 (0 = pad;
    #                           negative = local orientation flipped)
    n_dev: int
    n_loc: int                # owned cells per shard (padded count)
    fv_meta: tuple
    halo_perms: tuple         # per round ((src, dst), ...)
    devices: tuple
    shards: tuple = ()

    @property
    def n_halo(self) -> int:
        return self.send.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return canonical_float(self.sf.dtype)

    def halo_stats(self) -> dict:
        """The exchange's rounds and (src, dst) pairs."""
        return {"rounds": sum(1 for p in self.halo_perms if p),
                "pairs": sum(len(p) for p in self.halo_perms)}


def _build_shards(arrs: dict, fv_meta, devices) -> tuple:
    """Each shard's tensors on its device from the stacked host arrays."""
    c_ext, n_faces, n_int, patch_slices = fv_meta
    fdt = canonical_float(arrs["sf"].dtype)
    out = []
    for s, dev in enumerate(devices):
        as_f = lambda x: torch.as_tensor(np.ascontiguousarray(x[s]), dtype=fdt,  # noqa: E731
                                         device=dev)
        as_i = lambda x: torch.as_tensor(np.ascontiguousarray(x[s]),  # noqa: E731
                                         dtype=torch.int64, device=dev)
        m = fv.FvMesh(owner=as_i(arrs["owner"]), neighbour=as_i(arrs["neighbour"]),
                      sf=as_f(arrs["sf"]), mag_sf=as_f(arrs["mag_sf"]), cf=as_f(arrs["cf"]),
                      cc=as_f(arrs["cc"]), vol=as_f(arrs["vol"]), w=as_f(arrs["w"]),
                      delta=as_f(arrs["delta"]), bd_delta=as_f(arrs["bd_delta"]),
                      nonortho=as_f(arrs["nonortho"]), n_cells=c_ext, n_faces=n_faces,
                      n_internal=n_int, patch_slices=patch_slices)
        mask = torch.as_tensor(arrs["cell_mask"][s], device=dev)
        fg = arrs["fglob"][s]
        loc = np.nonzero(fg != 0)[0]
        to0 = lambda x, dt=torch.int64: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=devices[0])
        out.append(Shard(m=m, mask=mask, maskf=mask.to(fdt), send=as_i(arrs["send"]),
                         device=torch.device(dev),
                         glob0=to0(arrs["glob_cell"][s][arrs["cell_mask"][s]]),
                         face_loc0=to0(loc), face_gid0=to0(np.abs(fg[loc]) - 1),
                         face_sign0=to0(np.sign(fg[loc]), fdt)))
    return tuple(out)


def make_sharded_flow_mesh(arrs: dict, n_dev: int, n_loc: int, fv_meta, halo_perms,
                           devices) -> ShardedFlowMesh:
    """A :class:`ShardedFlowMesh` of stacked host arrays (JAX's field
    names), its shard tensors built on ``devices``."""
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_dev:
        raise ValueError(f"{len(devices)} devices for {n_dev} shards")
    fv_meta = tuple(fv_meta)
    return ShardedFlowMesh(**{k: arrs[k] for k in HOST_FIELDS}, n_dev=n_dev, n_loc=int(n_loc),
                           fv_meta=fv_meta, halo_perms=tuple(halo_perms), devices=devices,
                           shards=_build_shards(arrs, fv_meta, devices))


def rcb_map(cc, n_dev: int) -> np.ndarray:
    """Recursive coordinate bisection: split the cell set along its
    longest-extent axis into proportionally sized halves until ``n_dev``
    parts (any device count, not just powers of two)."""
    cc = np.asarray(cc, np.float64)
    dev = np.zeros(len(cc), np.int64)

    def rec(idx, k, base):
        if k == 1:
            dev[idx] = base
            return
        ka = k // 2
        ext = cc[idx].max(axis=0) - cc[idx].min(axis=0)
        ax = int(np.argmax(ext))
        order = idx[np.argsort(cc[idx, ax], kind="stable")]
        cut = int(round(len(idx) * ka / k))
        rec(order[:cut], ka, base)
        rec(order[cut:], k - ka, base + ka)

    rec(np.arange(len(cc), dtype=np.int64), n_dev, 0)
    return dev


def _cell_map(gm_host, pm, n_dev, direction, grid, cell_map):
    """Cell -> device of the decomposition (JAX's ``decompose`` branches)."""
    nc, n_int = pm.n_cells, pm.n_internal_faces
    cc, own, nei = gm_host["cc"], gm_host["owner"], gm_host["neighbour"]
    if cell_map is not None:
        dev_of = np.asarray(cell_map, np.int64)
        if dev_of.shape != (nc,):
            raise ValueError(f"cell_map shape {dev_of.shape} != ({nc},)")
        if dev_of.min() < 0 or dev_of.max() >= n_dev:
            raise ValueError(f"cell_map device ids outside [0, {n_dev})")
        return dev_of
    if isinstance(grid, str):
        if grid == "rcb":
            return rcb_map(cc, n_dev)
        if grid == "graph":
            from . import graphpart

            return graphpart.graph_map(nc, own[:n_int], nei, n_dev, coords=cc)
        raise ValueError(f"unknown decomposition method {grid!r}")
    if grid is None:
        grid = [1, 1, 1]
        grid[direction] = n_dev
    gx, gy, gz = (int(g) for g in grid)
    if gx * gy * gz != n_dev:
        raise ValueError(f"decomposition grid {tuple(grid)} != {n_dev} devices")

    def split(idx, axis_c, k):
        order = idx[np.argsort(cc[idx, axis_c], kind="stable")]
        bounds = np.linspace(0, len(idx), k + 1).astype(np.int64)
        return [order[bounds[i] : bounds[i + 1]] for i in range(k)]

    dev_of = np.empty(nc, np.int64)
    for ix, sx in enumerate(split(np.arange(nc), 0, gx)):
        for iy, sy in enumerate(split(sx, 1, gy)):
            for iz, sz in enumerate(split(sy, 2, gz)):
                dev_of[sz] = (ix * gy + iy) * gz + iz
    return dev_of


def decompose(pm, n_dev: int, dtype=None, direction: int = 0, grid=None, cell_map=None,
              devices=None, device=None):
    """Decompose a PolyMesh into a :class:`ShardedFlowMesh` on ``devices``
    (default ``make_device_mesh(n_dev, device)``: the card unless
    ``device`` says otherwise) in ``dtype`` (default float32).  Returns
    (smesh, bglob): ``bglob[d, j]`` is the global boundary-face index of
    shard d's boundary slot j (-1 padding).

    ``grid=(gx, gy, gz)`` selects a multi-axis block decomposition (the
    decomposeParDict ``simple``/``hierarchical`` method, order xyz);
    ``grid="rcb"`` recursive coordinate bisection; ``grid="graph"`` the
    multilevel graph bisection of :mod:`.graphpart`; ``cell_map`` any
    explicit [n_cells] cell -> device map.  Default: 1-D slabs along
    ``direction``.  The halo exchange has one directed round per device-id
    delta observed across cross faces.

    The arrays equal JAX's ``decompose`` in the same dtype; its loops over
    every internal face per device are numpy masks here, in global face
    order."""
    from ..io.polymesh import face_centres_areas

    np_dt = numpy_float(dtype)
    gm = fv.fv_mesh(pm, dtype=dtype, device="cpu")
    g = {k: fv.host(getattr(gm, k)) for k in ("owner", "neighbour", "mag_sf", "w", "delta",
                                               "nonortho", "vol", "bd_delta", "cc")}
    g["cc"] = g["cc"].astype(np.float64)
    nc, n_int, n_faces = pm.n_cells, pm.n_internal_faces, pm.n_faces
    own, nei = g["owner"], g["neighbour"]
    dev_of = _cell_map(g, pm, n_dev, direction, grid, cell_map)
    cc = g["cc"]

    # exchange rounds: one directed round per distinct device-id delta
    # across cross faces (no adjacency requirement on the map)
    do, dn = dev_of[own[:n_int]], dev_of[nei]
    cross = do != dn
    deltas = sorted({int(v) for v in np.unique(dn[cross] - do[cross])}
                    | {int(v) for v in np.unique(do[cross] - dn[cross])})
    dirs = [d for d in deltas if d != 0]
    n_rounds = max(len(dirs), 1)

    # local numbering per device (owned cells in global order)
    n_owned = np.bincount(dev_of, minlength=n_dev).astype(np.int64)
    order = np.argsort(dev_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(n_owned)])
    loc_id = np.empty(nc, np.int64)
    loc_id[order] = np.arange(nc) - np.repeat(starts[:-1], n_owned)
    cells_of = [order[starts[d] : starts[d + 1]] for d in range(n_dev)]
    n_loc = int(n_owned.max())

    # send lists per device per round: cells with a cross face whose other
    # cell sits delta_r device-ids away
    send = [[np.array([], np.int64) for _ in range(n_rounds)] for _ in range(n_dev)]
    fa, fb = own[:n_int][cross], nei[cross]
    da, db = do[cross], dn[cross]
    for r, st in enumerate(dirs):
        ab = (db - da) == st          # a sends to db
        ba = (da - db) == st          # b sends to da
        for d in range(n_dev):
            s = np.concatenate([fa[ab & (da == d)], fb[ba & (db == d)]])
            send[d][r] = np.unique(s) if len(s) else np.array([], np.int64)
    n_halo = max([len(s) for rounds in send for s in rounds] + [1])
    c_ext = n_loc + n_rounds * n_halo + 1
    dummy = c_ext - 1

    halo_perms = tuple(
        tuple((d, d + st) for d in range(n_dev) if 0 <= d + st < n_dev and len(send[d][r]))
        for r, st in enumerate(dirs)) or ((),)

    # ghost slot of a neighbour's cell: round r's ghosts on device d come
    # from sender d - delta_r
    ghost_of = np.full((n_dev, nc), -1, np.int64)
    for r, st in enumerate(dirs):
        g0 = n_loc + r * n_halo
        for d in range(n_dev):
            sender = d - st
            if 0 <= sender < n_dev and len(send[sender][r]):
                ghost_of[d, send[sender][r]] = g0 + np.arange(len(send[sender][r]))

    f_ctr, f_area = face_centres_areas(pm)
    fid = np.arange(n_int)
    dev_faces, dev_bd = [], []
    for d in range(n_dev):
        # internal-local faces and cross faces (as internal with a ghost
        # neighbour) in global face order, then the device's boundary faces
        mine = (do == d) | (dn == d)
        f = fid[mine]
        a, b = own[f], nei[f]
        keep = do[f] == d            # local cell is the global owner
        loc_own = np.where(keep, loc_id[a], loc_id[b])
        other = np.where(keep, b, a)
        same = (do[f] == d) & (dn[f] == d)
        loc_nei = np.where(same, loc_id[b], ghost_of[d, other])
        sgn = np.where(keep, 1.0, -1.0)
        w_l = np.where(keep, g["w"][f], 1.0 - g["w"][f])
        fg = np.where(keep, f + 1, -(f + 1))
        dev_faces.append((loc_own, loc_nei, sgn[:, None] * f_area[f], g["mag_sf"][f], w_l,
                          g["delta"][f], sgn[:, None] * g["nonortho"][f], f_ctr[f], fg))
        bf = n_int + np.nonzero(dev_of[own[n_int:]] == d)[0]
        dev_bd.append((loc_id[own[bf]], f_area[bf], g["mag_sf"][bf],
                       g["bd_delta"][bf - n_int], bf - n_int, f_ctr[bf]))

    nf_int = max(len(t[0]) for t in dev_faces)
    nf_bd = max(max(len(t[0]) for t in dev_bd), 1)

    def padded(arr, n, fill=0.0, dt=np.float64):
        arr = np.asarray(arr, dt)
        out = np.full((n,) + arr.shape[1:], fill, dt)
        out[: len(arr)] = arr
        return out

    st_ = {k: [] for k in HOST_FIELDS}
    bglob = []
    for d in range(n_dev):
        oi, ni_, sfl, magl, wl, dl, kl, cfl, fgl = dev_faces[d]
        bo, bsf, bmag, bdl, bgl, bcf = dev_bd[d]
        # padded faces: zero geometry, both cells -> dummy (no contribution)
        st_["owner"].append(np.concatenate([padded(oi, nf_int, dummy, np.int64),
                                            padded(bo, nf_bd, dummy, np.int64)]))
        st_["neighbour"].append(padded(ni_, nf_int, dummy, np.int64))
        st_["sf"].append(np.concatenate([padded(sfl.reshape(-1, 3), nf_int),
                                         padded(bsf.reshape(-1, 3), nf_bd)]))
        st_["mag_sf"].append(np.concatenate([padded(magl, nf_int), padded(bmag, nf_bd)]))
        st_["w"].append(padded(wl, nf_int, 0.5))
        st_["delta"].append(padded(dl, nf_int))
        st_["nonortho"].append(padded(kl.reshape(-1, 3), nf_int))
        st_["bd_delta"].append(padded(bdl, nf_bd))
        cells_d = cells_of[d]
        volv = np.ones(c_ext)
        volv[: len(cells_d)] = g["vol"][cells_d]
        st_["vol"].append(volv)
        # cell centres incl. GHOST slots (linearUpwind's d_up and
        # limitedLinear's d read remote upwind centres)
        ccv = np.zeros((c_ext, 3))
        ccv[: len(cells_d)] = cc[cells_d]
        for r, stp in enumerate(dirs):
            if 0 <= d - stp < n_dev:
                sl = send[d - stp][r]
                ccv[n_loc + r * n_halo : n_loc + r * n_halo + len(sl)] = cc[sl]
        st_["cc"].append(ccv)
        st_["cf"].append(np.concatenate([padded(cfl.reshape(-1, 3), nf_int),
                                         padded(bcf.reshape(-1, 3), nf_bd)]))
        st_["send"].append(np.stack([
            padded(loc_id[s] if len(s) else np.array([0], np.int64), n_halo, 0, np.int64)
            for s in send[d]]))
        maskv = np.zeros(c_ext, bool)
        maskv[: n_owned[d]] = True
        st_["cell_mask"].append(maskv)
        gl = np.full(c_ext, -1, np.int64)
        gl[: len(cells_d)] = cells_d
        st_["glob_cell"].append(gl)
        bglob.append(padded(bgl, nf_bd, -1, np.int64))
        st_["fglob"].append(np.concatenate([padded(fgl, nf_int, 0, np.int64),
                                            padded(np.asarray(bgl, np.int64) + n_int + 1,
                                                   nf_bd, 0, np.int64)]))

    floats = ("sf", "mag_sf", "cf", "cc", "vol", "w", "delta", "bd_delta", "nonortho")
    arrs = {k: np.stack(v).astype(np_dt if k in floats else v[0].dtype) for k, v in st_.items()}
    if devices is None:
        devices = make_device_mesh(n_dev, device)
    smesh = make_sharded_flow_mesh(arrs, n_dev, n_loc, (c_ext, nf_int + nf_bd, nf_int, ()),
                                   halo_perms, devices)
    return smesh, np.stack(bglob)


# ---------------------------------------------------------------------------
# host-side scatter / gather between the global fields and the shards
# ---------------------------------------------------------------------------


def _put(smesh: ShardedFlowMesh, arrs) -> list:
    """Per-shard tensors of a stacked numpy array (floats in the mesh's dtype)."""
    fdt = smesh.dtype if np.issubdtype(arrs.dtype, np.floating) else None
    return [torch.as_tensor(np.ascontiguousarray(arrs[s]), dtype=fdt, device=dev)
            for s, dev in enumerate(smesh.devices)]


def _np(x) -> np.ndarray:
    return fv.host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def shard_bcs(bc: fv.BoundaryCoeffs, bglob, smesh: ShardedFlowMesh) -> list:
    """Per-shard BoundaryCoeffs by the shards' boundary-face lists (padded
    faces get a=1, b=0: zeroGradient into the dummy cell).  ``slip_mask``
    is kept where the global BCs have one (all False on a shard without
    slip faces)."""
    a, b = _np(bc.a), _np(bc.b)
    io = _np(bc.io_mask) if bc.io_mask is not None else None
    iov = _np(bc.io_value) if bc.io_value is not None else None
    sm = _np(bc.slip_mask) if bc.slip_mask is not None else None
    bg = np.asarray(bglob)
    D, B = bg.shape
    a_s = np.ones((D, B), a.dtype)
    b_s = np.zeros((D, B, b.shape[1]), b.dtype)
    io_s = np.zeros((D, B), bool)
    iov_s = np.zeros((D, B, b.shape[1]), b.dtype)
    sm_s = np.zeros((D, B), bool)
    valid = bg >= 0
    a_s[valid] = a[bg[valid]]
    b_s[valid] = b[bg[valid]]
    if io is not None:
        io_s[valid] = io[bg[valid]]
        iov_s[valid] = iov[bg[valid]]
    if sm is not None:
        sm_s[valid] = sm[bg[valid]]
    fdt = smesh.dtype
    out = []
    for s, dev in enumerate(smesh.devices):
        out.append(fv.BoundaryCoeffs(
            a=torch.as_tensor(a_s[s], dtype=fdt, device=dev),
            b=torch.as_tensor(b_s[s], dtype=fdt, device=dev),
            io_mask=torch.as_tensor(io_s[s], device=dev),
            io_value=torch.as_tensor(iov_s[s], dtype=fdt, device=dev),
            slip_mask=torch.as_tensor(sm_s[s], device=dev) if sm is not None else None))
    return out


def scatter_cells(smesh: ShardedFlowMesh, x_global, fill=0.0) -> list:
    """Global per-cell array -> per-shard extended tensors."""
    gl = smesh.glob_cell
    xg = _np(x_global)
    out = np.full(gl.shape + xg.shape[1:], fill, xg.dtype)
    valid = gl >= 0
    out[valid] = xg[gl[valid]]
    return _put(smesh, out)


def scatter_faces(smesh: ShardedFlowMesh, x_global) -> list:
    """Global per-face array -> per-shard face tensors via the signed
    global-face map (flipped cross faces negate; padded slots 0)."""
    fg = smesh.fglob
    x = _np(x_global)
    out = np.zeros(fg.shape + x.shape[1:], x.dtype)
    pos, neg = fg > 0, fg < 0
    out[pos] = x[fg[pos] - 1]
    out[neg] = -x[-fg[neg] - 1]
    return _put(smesh, out)


def gather_cells(smesh: ShardedFlowMesh, xs, n_cells: int | None = None):
    """Per-shard extended tensors -> the global per-cell tensor on shard 0's
    device (each shard's owned slots, the first ones, by their global ids)."""
    nc = int(smesh.glob_cell.max()) + 1 if n_cells is None else n_cells
    out = xs[0].new_zeros((nc,) + tuple(xs[0].shape[1:]), device=smesh.devices[0])
    for sh, x in zip(smesh.shards, xs):
        out[sh.glob0] = x[: sh.glob0.shape[0]].to(out.device)
    return out


def gather_faces(smesh: ShardedFlowMesh, fluxes, n_faces: int):
    """Per-shard face fluxes -> the global face flux on shard 0's device
    through the signed global-face map; a cross face is on two shards, and
    the later shard's value stands (as JAX's numpy assignment leaves it)."""
    out = fluxes[0].new_zeros(n_faces, device=smesh.devices[0])
    for sh, fl in zip(smesh.shards, fluxes):
        out[sh.face_gid0] = sh.face_sign0 * fl.to(out.device)[sh.face_loc0]
    return out


def refresh_sharded_geometry(smesh: ShardedFlowMesh, m_new: fv.FvMesh) -> ShardedFlowMesh:
    """Re-scatter the per-shard FV geometry from a MOVED global mesh (same
    topology: the sharded ``mesh.controlledUpdate()``,
    ``cudaParticlesPimpleFoam.C:144-170``).  The decomposition (cell and
    face assignment, halo rounds, shapes) is pinned; only the geometry
    changes."""
    fg = smesh.fglob
    nf_int_l = smesh.fv_meta[2]
    n_int_g = m_new.n_internal
    gh = {k: fv.host(getattr(m_new, k)).astype(np.float64)
          for k in ("sf", "mag_sf", "cf", "w", "delta", "nonortho", "bd_delta", "vol", "cc")}

    D, NF = fg.shape
    gid = np.abs(fg) - 1
    valid = fg != 0
    sign = np.sign(fg).astype(np.float64)
    sf = np.zeros((D, NF, 3))
    sf[valid] = sign[valid, None] * gh["sf"][np.clip(gid[valid], 0, None)]
    mag = np.zeros((D, NF))
    mag[valid] = gh["mag_sf"][gid[valid]]
    cfv = np.zeros((D, NF, 3))
    cfv[valid] = gh["cf"][gid[valid]]

    fgi = fg[:, :nf_int_l]
    vi = fgi != 0
    gii = np.abs(fgi) - 1
    w = np.full((D, nf_int_l), 0.5)
    w[vi] = np.where(fgi[vi] > 0, gh["w"][gii[vi]], 1.0 - gh["w"][gii[vi]])
    delta = np.zeros((D, nf_int_l))
    delta[vi] = gh["delta"][gii[vi]]
    nonor = np.zeros((D, nf_int_l, 3))
    nonor[vi] = np.sign(fgi[vi]).astype(np.float64)[:, None] * gh["nonortho"][gii[vi]]

    fgb = fg[:, nf_int_l:]
    vb = fgb != 0
    bd_delta = np.zeros((D, NF - nf_int_l))
    bd_delta[vb] = gh["bd_delta"][np.abs(fgb[vb]) - 1 - n_int_g]

    gl = smesh.glob_cell
    vol = np.ones(gl.shape)
    vol[gl >= 0] = gh["vol"][gl[gl >= 0]]
    cc = np.zeros(gl.shape + (3,))
    cc[gl >= 0] = gh["cc"][gl[gl >= 0]]
    # ghost cell centres: round r on device dst come from sender src; send
    # lists hold SENDER-local cell ids
    send, H, n_loc = smesh.send, smesh.n_halo, smesh.n_loc
    for r, pairs in enumerate(smesh.halo_perms):
        for src, dst in pairs:
            gsend = gl[src, send[src, r]]
            cc[dst, n_loc + r * H : n_loc + (r + 1) * H] = gh["cc"][np.clip(gsend, 0, None)]

    dt = smesh.sf.dtype
    arrs = {k: getattr(smesh, k) for k in HOST_FIELDS}
    arrs.update(sf=sf.astype(dt), mag_sf=mag.astype(dt), cf=cfv.astype(dt), cc=cc.astype(dt),
                vol=vol.astype(dt), w=w.astype(dt), delta=delta.astype(dt),
                bd_delta=bd_delta.astype(dt), nonortho=nonor.astype(dt))
    return make_sharded_flow_mesh(arrs, smesh.n_dev, smesh.n_loc, smesh.fv_meta,
                                  smesh.halo_perms, smesh.devices)


def shard_mrf(smesh: ShardedFlowMesh, mrf, m: fv.FvMesh):
    """Per-shard MRF zone data from global :class:`..models.mrf.MRFZones`:
    cell omega [C_ext, 3] (zero on ghosts and pads: Coriolis is an
    owned-cell source) and the static frame face flux ``(Omega x (Cf -
    origin)) . Sf`` in LOCAL face orientation (flipped cross faces carry
    the negated global value)."""
    from ..models import mrf as mrf_mod

    om_s = scatter_cells(smesh, _np(mrf.cell_omega))
    return om_s, scatter_faces(smesh, fv.host(mrf_mod.frame_flux(mrf, m)))


def read_decompose_par(case_dir, n_dev: int, log=print):
    """Decomposition grid from ``system/decomposeParDict`` (the
    ``simple``/``hierarchical`` method's ``n (nx ny nz)`` coefficient,
    ``TJunction/system/decomposeParDict:17-24``).  Returns None (1-D
    default) when the dict is absent, the method is unsupported, or the
    subdomain/device counts disagree; "rcb" and "graph" for those
    methods."""
    from ..io import foamfile

    path = os.path.join(case_dir, "system", "decomposeParDict")
    if not os.path.exists(path):
        return None
    try:
        d = foamfile.read(path)
    except Exception:
        return None
    method = str(d.get("method", "")).strip()
    coeffs = d.get("coeffs") or d.get(f"{method}Coeffs") or {}
    n = coeffs.get("n") if isinstance(coeffs, dict) else None
    nsub = d.get("numberOfSubdomains")
    if method == "rcb":
        log("#flow: decomposition by recursive coordinate bisection")
        return "rcb"
    if method in ("scotch", "metis", "kahip"):
        log(f"#flow: decomposeParDict method {method!r}: multilevel "
            "graph bisection")
        return "graph"
    if method not in ("simple", "hierarchical") or n is None:
        if method:
            log(f"#flow: decomposeParDict method {method!r} not supported "
                "on-device; using 1-D slabs")
        return None
    grid = tuple(int(v) for v in n)
    if len(grid) != 3 or grid[0] * grid[1] * grid[2] != n_dev:
        log(f"#flow: decomposeParDict n {grid} != {n_dev} devices; "
            "using 1-D slabs")
        return None
    if nsub is not None and int(nsub) != n_dev:
        log(f"#flow: numberOfSubdomains {nsub} != {n_dev} devices; "
            "using 1-D slabs")
        return None
    log(f"#flow: decomposition grid {grid} (decomposeParDict {method})")
    return grid


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def halo_refresh(smesh: ShardedFlowMesh, xs) -> list:
    """Fill each shard's ghost blocks from its neighbours' send lists (JAX's
    per-round ``lax.ppermute``); returns new tensors, ``xs`` unchanged.  A
    ghost block no round fills keeps the input's values: no face reads it."""
    n_loc, H = smesh.n_loc, smesh.n_halo
    n_rounds = smesh.send.shape[1]
    recv = [{} for _ in xs]
    for r, pairs in enumerate(smesh.halo_perms):
        for src, dst in pairs:
            with on_device(smesh.devices[src]):
                blk = xs[src][smesh.shards[src].send[r]]
            recv[dst][r] = blk.to(smesh.devices[dst])
            halo_refresh.bytes += blk.numel() * blk.element_size()
    halo_refresh.calls += 1
    out = []
    for s, x in enumerate(xs):
        if not recv[s]:
            out.append(x)
            continue
        pieces = [x[:n_loc]]
        for r in range(n_rounds):
            g0 = n_loc + r * H
            pieces.append(recv[s].get(r, x[g0 : g0 + H]))
        pieces.append(x[n_loc + n_rounds * H :])
        with on_device(smesh.devices[s]):
            out.append(torch.cat(pieces))
    return out


halo_refresh.calls = 0       # refreshes since the last reset (chip_smoke.py, the driver)
halo_refresh.bytes = 0       # bytes the refreshes moved between shards


def psum(xs):
    """Sum of per-shard 0-dim tensors on shard 0's device, in shard order."""
    dev0 = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(dev0)
    return total


def pmax(xs):
    """Maximum of per-shard 0-dim tensors on shard 0's device."""
    dev0 = xs[0].device
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x.to(dev0))
    return out


def _on(smesh: ShardedFlowMesh, x) -> list:
    """A tensor of shard 0 (a psum'd scalar) on every shard's device."""
    return [x.to(dev) for dev in smesh.devices]


def _psum_dot(smesh, a, b) -> torch.Tensor:
    return psum([torch.sum(torch.where(sh.mask, x * y, 0.0))
                 for sh, x, y in zip(smesh.shards, a, b)])


def _safe_diag(sh: Shard, d):
    return torch.where(sh.mask, d, 1.0)


def _sharded_cg(smesh, As, bs, x0s, tol, max_iter, precond):
    """Preconditioned CG over the shards in lockstep with JAX's while-loop
    semantics (``flowshard.py:643-658``, ``:790-831``): every shard's
    matvec after one halo refresh, one psum per dot product and one host
    read of the exit test per iteration.  ``precond(s, r)`` is shard s's
    M^-1.  Returns (xs, |r|/|b| on shard 0's device, iterations)."""
    shards = smesh.shards

    def mv(xs):
        xh = halo_refresh(smesh, xs)
        return [torch.where(sh.mask, fv.matvec(sh.m, A, x), 0.0)
                for sh, A, x in zip(shards, As, xh)]

    bs = [torch.where(sh.mask, b, 0.0) for sh, b in zip(shards, bs)]
    xs = list(x0s)
    rs = [b - y for b, y in zip(bs, mv(xs))]
    zs = [precond(s, r) for s, r in enumerate(rs)]
    rz = _psum_dot(smesh, rs, zs)
    nb = torch.sqrt(_psum_dot(smesh, bs, bs)) + 1e-300
    ps = zs
    it = 0
    while it < max_iter and bool(torch.sqrt(_psum_dot(smesh, rs, rs)) / nb > tol):
        aps = mv(ps)
        alpha = _on(smesh, rz / (_psum_dot(smesh, ps, aps) + 1e-300))
        xs = [x + al * p for x, al, p in zip(xs, alpha, ps)]
        rs = [r - al * ap for r, al, ap in zip(rs, alpha, aps)]
        zs = [precond(s, r) for s, r in enumerate(rs)]
        rzn = _psum_dot(smesh, rs, zs)
        beta = _on(smesh, rzn / (rz + 1e-300))
        ps = [z + be * p for z, be, p in zip(zs, beta, ps)]
        rz = rzn
        it += 1
    return xs, torch.sqrt(_psum_dot(smesh, rs, rs)) / nb, it


def flux_init(smesh: ShardedFlowMesh, u, u_bcs) -> list:
    """The per-shard face flux of a sharded velocity field (the sharded
    ``fv.flux_of`` at case load; JAX ``make_flux_init``)."""
    uh = halo_refresh(smesh, u)
    return [fv.flux_of(sh.m, x, bc) for sh, x, bc in zip(smesh.shards, uh, u_bcs)]


def correct_flux(smesh: ShardedFlowMesh, flux, p_bcs, pin: bool = False):
    """``CorrectPhi`` on the decomposed mesh (``correctPhi.H:1-11``; JAX
    ``make_sharded_correct_flux``): project the per-shard face flux
    divergence-free by solving ``laplacian(1, pcorr) == div(phi)`` with a
    psum-global Jacobi-CG (tol 1e-8, 500 iterations).  Returns (flux,
    residual)."""
    shards = smesh.shards
    n_int = smesh.fv_meta[2]
    bc0 = [dataclasses.replace(bc, b=torch.zeros_like(bc.b)) for bc in p_bcs]
    Aps = [_pressure_matrix(sh.m, torch.ones_like(f), bc, pin and s == 0)[0]
           for s, (sh, f, bc) in enumerate(zip(shards, flux, bc0))]
    rhs = [torch.where(sh.mask, -fv.surface_sum(sh.m, f), 0.0) for sh, f in zip(shards, flux)]
    inv_d = [1.0 / _safe_diag(sh, A.diag) for sh, A in zip(shards, Aps)]
    x0 = [torch.zeros_like(r) for r in rhs]
    pc, res, _ = _sharded_cg(smesh, Aps, rhs, x0, 1e-8, 500, lambda s, r: inv_d[s] * r)
    out = []
    for sh, f, bc, p in zip(shards, flux, bc0, halo_refresh(smesh, pc)):
        m = sh.m
        dp = p[m.neighbour] - p[m.own_i]
        flux_i = f[:n_int] - m.delta * dp
        dp_b = (bc.a - 1.0) * p[m.own_b]
        flux_b = f[n_int:] - m.bd_delta * dp_b
        out.append(torch.cat([flux_i, flux_b]))
    return out, res


# ---------------------------------------------------------------------------
# the sharded PIMPLE step
# ---------------------------------------------------------------------------


def make_sharded_pimple(smesh: ShardedFlowMesh, cfg, with_turb: bool = False,
                        lamg: "LocalAmg | None" = None, with_mrf: bool = False,
                        with_fvo: bool = False, fvo_mvf: bool = False):
    """The PIMPLE step over the shards (JAX ``make_sharded_pimple``).

    Returns ``step(smesh, u, p, flux, u_bcs, p_bcs, dt[, lamg][, mrf_omega,
    mrf_flux][, fvo_su, fvo_sp, fvo_mask, par][, nut, k, wall_cell, y_wall,
    wall_bd])``; every sharded argument is a list of per-shard tensors (or
    BoundaryCoeffs), ``par`` one tensor [dir_x, dir_y, dir_z, magUbar,
    relax, grad_p0, dgrad] and ``lamg`` a :class:`LocalAmg`.  Returns (u,
    p, flux, diag): per-shard lists, and ``diag`` with ``u_res``,
    ``p_res``, ``continuity`` (0-dim tensors on shard 0's device),
    ``p_iters`` (the CG iterations of each pressure solve) and, with
    fvOptions, ``fvo_grad_p`` / ``fvo_dgrad``.

    With ``with_turb`` the momentum diffusivity is nu + nut (faces from the
    halo-refreshed cell field, wall faces by the nutkWallFunction); with
    ``with_mrf`` the Coriolis source over zone cells and the relative
    convective flux (the rotating-wall velocity is applied to the GLOBAL u
    BCs before sharding); with ``with_fvo`` the momentum fvOptions and,
    with ``fvo_mvf``, the meanVelocityForce with psum-global zone
    averages."""
    use_amg = lamg is not None
    n_int = smesh.fv_meta[2]

    def step(sm, u, p, flux, u_bcs, p_bcs, dt, *extra):
        shards, S = sm.shards, sm.n_dev
        rng = range(S)
        hx = lambda xs: halo_refresh(sm, xs)  # noqa: E731
        dtype = u[0].dtype
        extra = list(extra)
        lam = extra.pop(0) if use_amg else None
        mrf_om = mrf_ff = None
        if with_mrf:
            mrf_om, mrf_ff = extra.pop(0), extra.pop(0)
        if with_fvo:
            fvo_su, fvo_sp, fvo_mask, par0 = (extra.pop(0) for _ in range(4))
            par = _on(sm, par0)
        vol = [sh.m.vol for sh in shards]

        if with_turb:
            nut, k_t, wall_cell, y_wall, wall_bd = extra
            nut_h = hx(nut)
            nu_f = [cfg.nu + torch.cat([
                fv.face_interp(sh.m, nh),
                _wall_nut_bd_local(sh.m, nh, kk, wc, yw, wb, cfg.nu, n_int)])
                for sh, nh, kk, wc, yw, wb in zip(shards, nut_h, k_t, wall_cell, y_wall,
                                                  wall_bd)]
        else:
            nu_f = [cfg.nu] * S

        def jacobi(As, bs, x0s, sweeps):
            inv_d = [1.0 / _safe_diag(sh, A.diag) for sh, A in zip(shards, As)]
            xs = x0s
            for _ in range(sweeps):
                xs = hx(xs)
                xs = [torch.where(sh.mask[:, None],
                                  x + iv[:, None] * (b - fv.matvec(sh.m, A, x)), 0.0)
                      for sh, A, b, x, iv in zip(shards, As, bs, xs, inv_d)]
            return xs

        def cg(As, bs, x0s, tol, max_iter):
            if use_amg:
                diag0 = [_safe_diag(sh, A.diag) for sh, A in zip(shards, As)]
                off0 = [A.upper * lam.shard[s]["off_mask"] for s, A in enumerate(As)]
                levels = [_local_coarse_ops(lam, s, shards[s].m, diag0[s], off0[s])
                          for s in rng]

                def precond(s, r):
                    sh = shards[s]
                    z = _local_vcycle(lam, s, sh.m, diag0[s], off0[s], levels[s],
                                      torch.where(sh.mask, r, 0.0))
                    return torch.where(sh.mask, z, 0.0)
            else:
                inv_d = [1.0 / _safe_diag(sh, A.diag) for sh, A in zip(shards, As)]

                def precond(s, r):
                    return inv_d[s] * r

            return _sharded_cg(sm, As, bs, x0s, tol, max_iter, precond)

        dt_t = torch.as_tensor(dt, dtype=dtype)
        ddt = [torch.where(sh.mask, v / dt_t.to(v.device), 0.0) for sh, v in zip(shards, vol)]
        u_old = u

        g_mvf = par0[5] if with_fvo else None
        dg_mvf = par0[6] if with_fvo else None

        def mvf_correct(uu, rau):
            # fvOptions.correct(U): the meanVelocityForce feedback step with
            # psum-global zone averages (halo slots carry zero mask weight)
            w = [sh.maskf * fm * v for sh, fm, v in zip(shards, fvo_mask, vol)]
            d = [pp[:3] for pp in par]
            vz = psum([torch.sum(x) for x in w]) + 1e-300
            ubar_star = psum([torch.sum(x * (q @ dd)) for x, q, dd in zip(w, uu, d)]) / vz
            rau_ave = psum([torch.sum(x * ra) for x, ra in zip(w, rau)]) / vz
            dgrad = par0[4] * (par0[3] - ubar_star) / rau_ave
            dg = _on(sm, dgrad)
            uu = [q + (sh.maskf * fm * ra * g)[:, None] * dd[None, :]
                  for sh, q, fm, ra, g, dd in zip(shards, uu, fvo_mask, rau, dg, d)]
            return uu, dgrad

        u_res = torch.zeros((), dtype=dtype, device=sm.devices[0])
        p_res = u_res
        p_iters = []
        for _outer in range(cfg.n_outer):
            u_bcs_e = [fv.effective_bcs(bc, f[n_int:]) for bc, f in zip(u_bcs, flux)]
            uh = hx(u)
            As = [fv.assemble_transport(sh.m, f, nf, bc, 3, ddt_coeff=dd, phi_old=uo)
                  for sh, f, nf, bc, dd, uo in zip(shards, flux, nu_f, u_bcs_e, ddt, u_old)]
            if with_fvo:
                # fvOptions.constrain(UEqn): implicit Sp onto the diagonal and
                # the pending mvf increment folded into gradP0
                As = [dataclasses.replace(A, diag=A.diag - torch.where(sh.mask, sp, 0.0) * v)
                      for sh, A, sp, v in zip(shards, As, fvo_sp, vol)]
                if fvo_mvf:
                    g_mvf = g_mvf + dg_mvf
                    dg_mvf = torch.zeros_like(dg_mvf)
            ph = hx(p)
            grad_p = [fv.gradient(sh.m, x, bc) for sh, x, bc in zip(shards, ph, p_bcs)]
            bs = [A.source - gp * v[:, None] for A, gp, v in zip(As, grad_p, vol)]
            if cfg.div_scheme not in ("upwind", "", None):
                # per-component velocity gradient, halo-refreshed so remote
                # upwind cells carry correct values at partition boundaries
                gus = []
                for sh, x, bc, v in zip(shards, uh, u_bcs_e, vol):
                    pf = torch.cat([fv.face_interp(sh.m, x), fv.boundary_value(sh.m, bc, x)])
                    gus.append(fv.surface_sum(sh.m, pf[:, :, None] * sh.m.sf[:, None, :])
                               / v[:, None, None])
                gus = hx(gus)
                bs = [b + fv.convection_correction(sh.m, f, x, bc, cfg.div_scheme, grad=gu)
                      for sh, b, f, x, bc, gu in zip(shards, bs, flux, uh, u_bcs_e, gus)]
            if with_mrf:
                # MRF.DDt(U) moved to the RHS: -(Omega x U) V over zone cells
                bs = [b - torch.linalg.cross(om, x) * v[:, None]
                      for b, om, x, v in zip(bs, mrf_om, u, vol)]
            if with_fvo:
                # fvOptions(U): explicit Su + the meanVelocityForce's current
                # driving gradient
                g_now = _on(sm, g_mvf + dg_mvf) if fvo_mvf else None
                for s in rng:
                    src = fvo_su[s]
                    if fvo_mvf:
                        src = src + (fvo_mask[s] * g_now[s])[:, None] * par[s][:3]
                    bs[s] = bs[s] + src * vol[s][:, None]
            bs = [torch.where(sh.mask[:, None], b, 0.0) for sh, b in zip(shards, bs)]
            u_star = jacobi(As, bs, u, cfg.n_jacobi)
            # final momentum residual |b - A u*| / |b| (psum-global)
            ush = hx(u_star)
            r_u = [torch.where(sh.mask[:, None], b - fv.matvec(sh.m, A, x), 0.0)
                   for sh, A, b, x in zip(shards, As, bs, ush)]
            u_res = torch.sqrt(psum([torch.sum(r * r) for r in r_u])) / (
                torch.sqrt(psum([torch.sum(torch.where(sh.mask[:, None], b, 0.0) ** 2)
                                 for sh, b in zip(shards, bs)])) + 1e-300)

            rau = [v / _safe_diag(sh, A.diag) for sh, A, v in zip(shards, As, vol)]
            if fvo_mvf:
                # fvOptions.correct(U) after the momentum predictor
                u_star, dg_mvf = mvf_correct(u_star, rau)
            rauh = hx(rau)
            rau_f = [torch.cat([fv.face_interp(sh.m, x), x[sh.m.own_b]])
                     for sh, x in zip(shards, rauh)]
            # the pin on the global cell 0 (shard 0's first owned cell)
            Aps = [_pressure_matrix(sh.m, rf, bc, cfg.pin_pressure and s == 0)[0]
                   for s, (sh, rf, bc) in enumerate(zip(shards, rau_f, p_bcs))]

            u_corr = u_star
            p_res = torch.zeros((), dtype=dtype, device=sm.devices[0])
            for _c in range(cfg.n_correctors):
                uch = hx(u_corr)
                hbya = [(b + gp * v[:, None] - (fv.matvec(sh.m, A, xh) - A.diag[:, None] * x))
                        / _safe_diag(sh, A.diag)[:, None]
                        for sh, A, b, gp, v, xh, x in zip(shards, As, bs, grad_p, vol, uch,
                                                          u_corr)]
                hbyah = hx(hbya)
                phi_hbya = [fv.flux_of(sh.m, x, bc) for sh, x, bc in zip(shards, hbyah, u_bcs_e)]
                if with_mrf:
                    # MRF.makeRelative(phiHbyA) (pEqn.H:20)
                    phi_hbya = [f - ff for f, ff in zip(phi_hbya, mrf_ff)]
                rhs0 = [Ap.source[:, 0] - fv.surface_sum(sh.m, f)
                        for sh, Ap, f in zip(shards, Aps, phi_hbya)]
                # explicit non-orthogonal correctors (pEqn.H:42-57)
                corr = [torch.zeros(n_int, dtype=dtype, device=sh.device) for sh in shards]
                for no in range(cfg.n_nonortho + 1):
                    rhs = [torch.where(sh.mask, r0 + fv.surface_sum_internal(sh.m, c), 0.0)
                           for sh, r0, c in zip(shards, rhs0, corr)]
                    p, p_res, it_ = cg(Aps, rhs, p, cfg.p_tol, cfg.p_max_iter)
                    p_iters.append(it_)
                    if no < cfg.n_nonortho:
                        ph = hx(p)
                        gp = hx([fv.gradient(sh.m, x, bc)
                                 for sh, x, bc in zip(shards, ph, p_bcs)])
                        corr = []
                        for sh, g, rf in zip(shards, gp, rau_f):
                            m = sh.m
                            wgt = m.w[:, None]
                            gpf = wgt * g[m.own_i] + (1.0 - wgt) * g[m.neighbour]
                            corr.append(rf[:n_int] * torch.sum(m.nonortho * gpf, dim=-1))
                ph = hx(p)
                flux, u_corr = [], []
                for sh, x, f, rf, c, bc, hb, ra in zip(shards, ph, phi_hbya, rau_f, corr, p_bcs,
                                                       hbya, rau):
                    fl, uc, _ = pimple_correct(sh.m, ra, rf, hb, f, x, c, bc)
                    flux.append(fl)
                    u_corr.append(torch.where(sh.mask[:, None], uc, 0.0))
                if fvo_mvf:
                    # fvOptions.correct(U) per pressure corrector (pEqn.H:66)
                    u_corr, dg_mvf = mvf_correct(u_corr, rau)
            u = u_corr

        cont = psum([torch.sum(torch.abs(torch.where(sh.mask, fv.surface_sum(sh.m, f), 0.0)))
                     for sh, f in zip(shards, flux)])
        diag = {"u_res": u_res, "p_res": p_res, "p_iters": p_iters, "continuity": cont}
        if with_fvo:
            diag["fvo_grad_p"] = g_mvf if fvo_mvf else par0[5]
            diag["fvo_dgrad"] = dg_mvf if fvo_mvf else par0[6]
        return u, p, flux, diag

    return step


def _wall_nut_bd_local(m, nut_h, k, wall_cell, y_wall, wall_bd, nu, n_int):
    """A shard's nutkWallFunction boundary-face eddy viscosity
    (``turbulence.wall_nut_bd`` on the local boundary faces; padded entries
    have y_wall < 0 and land in one spare slot, sliced off)."""
    from ..models import turbulence as turb

    out = nut_h[m.own_b]
    valid = y_wall > 0.0
    wc = torch.clamp(wall_cell, min=0)
    kw = torch.clamp(k[wc], min=turb.SMALL)
    yplus = turb._div(turb.CMU ** 0.25 * torch.sqrt(kw) * torch.clamp(y_wall, min=0.0), nu)
    nut_w = torch.where(
        yplus > turb.YPLUS_LAM,
        nu * (yplus * turb.KAPPA
              / torch.log(torch.clamp(turb.E_WALL * yplus, min=1.0 + turb.SMALL)) - 1.0),
        0.0)
    nb = out.shape[0]
    ext = torch.cat([out, out.new_zeros(1)])
    ext[torch.where(valid, wall_bd, nb)] = torch.clamp(nut_w, min=0.0)
    return ext[:nb]


# ---------------------------------------------------------------------------
# the per-shard AMG preconditioner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class LocalAmg:
    """Per-shard additive-Schwarz AMG hierarchy (stacked + padded).

    Each shard preconditions its own block with a local V-cycle built by the
    same pairwise aggregation as the single-device GAMG stand-in
    (``fv.build_amg``); cross-shard couplings are left out of the
    preconditioner (zero-overlap additive Schwarz), while the CG stays
    globally exact through its psum'd dot products.  The host arrays
    (numpy, stacked [D, ...], padded to common per-level sizes) equal
    JAX's; ``shard[s]`` holds shard s's tensors."""

    aggs: tuple        # per level: [D, NCf_l] int64, pads -> NC_l (dropped)
    owners: tuple      # per level: [D, NF_l] coarse-face owner (pads 0)
    neighs: tuple      # per level: [D, NF_l]
    f2cf: tuple        # per level: [D, NFf_l] fine face -> coarse (-1 intra)
    off_mask: np.ndarray    # [D, n_int] 1.0 on owned-owned faces else 0.0
    sizes: tuple       # per level: (NC_l, NF_l)
    n_levels: int
    shard: tuple = ()  # per shard: {"aggs", "intra_agg", "aggs_c", "agg_valid", "owners",
    #                    "neighs", "f2cf", "off_mask"} tensors on its device


def _amg_shard_tensors(lamg: LocalAmg, smesh: ShardedFlowMesh) -> tuple:
    fdt = smesh.dtype
    out = []
    for s, dev in enumerate(smesh.devices):
        as_i = lambda x: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(x[s]), dtype=torch.int64, device=dev)
        aggs = [as_i(a) for a in lamg.aggs]
        owners, f2cf = [as_i(o) for o in lamg.owners], [as_i(f) for f in lamg.f2cf]
        # each fine internal face's coarse cell where both cells aggregate
        # into it, else the padded size (dropped): made once, so
        # fv.index_sum finds its table again
        intra, own = [], smesh.shards[s].m.own_i
        for a, f, (nc, _), o in zip(aggs, f2cf, lamg.sizes, owners):
            intra.append(torch.where(f < 0, a[own], nc))
            own = o
        out.append({
            "aggs": aggs,
            "intra_agg": intra,
            # the prolongation gathers a clipped index and zeroes the pads
            "aggs_c": [torch.clamp(a, max=nc - 1) for a, (nc, _) in zip(aggs, lamg.sizes)],
            "agg_valid": [(a < nc).to(fdt) for a, (nc, _) in zip(aggs, lamg.sizes)],
            "owners": owners,
            "neighs": [as_i(n) for n in lamg.neighs],
            "f2cf": f2cf,
            "off_mask": torch.as_tensor(lamg.off_mask[s], dtype=fdt, device=dev)})
    return tuple(out)


def make_local_amg(arrs: dict, smesh: ShardedFlowMesh) -> LocalAmg:
    """A :class:`LocalAmg` of host arrays (JAX's fields), with its shard
    tensors on ``smesh``'s devices."""
    lamg = LocalAmg(aggs=tuple(arrs["aggs"]), owners=tuple(arrs["owners"]),
                    neighs=tuple(arrs["neighs"]), f2cf=tuple(arrs["f2cf"]),
                    off_mask=np.asarray(arrs["off_mask"]), sizes=tuple(arrs["sizes"]),
                    n_levels=int(arrs["n_levels"]))
    return dataclasses.replace(lamg, shard=_amg_shard_tensors(lamg, smesh))


def build_local_amg(smesh: ShardedFlowMesh, min_coarse: int = 100,
                    max_levels: int = 16) -> LocalAmg:
    """Host-side per-shard hierarchies over the owned-cell subgraph (JAX's,
    array for array)."""
    D = smesh.n_dev
    n_loc = smesh.n_loc
    c_ext, _, n_int, _ = smesh.fv_meta
    own_all = smesh.owner[:, :n_int]
    nei_all = smesh.neighbour
    delta_all = smesh.delta.astype(np.float64)

    shards = []
    for d in range(D):
        own, nei, w = own_all[d], nei_all[d], delta_all[d]
        owned = (own < n_loc) & (nei < n_loc) & (w > 0)
        sel0 = np.nonzero(owned)[0]
        levels = []
        cur_own, cur_nei, cur_w = own[owned], nei[owned], w[owned]
        nc = n_loc
        while nc > min_coarse and len(levels) < max_levels and len(cur_own):
            matched, nc_c, own_c, nei_c, w_c, f2cf = fv._amg_pair_level(cur_own, cur_nei,
                                                                       cur_w, nc)
            levels.append((matched, nc_c, own_c, nei_c, f2cf))
            cur_own, cur_nei, cur_w, nc = own_c, nei_c, w_c, nc_c
        shards.append((sel0, levels))

    L = max((len(lv) for _, lv in shards), default=0)
    # extend shorter hierarchies with further pair levels (identity-safe)
    for d in range(D):
        sel0, levels = shards[d]
        own, nei, w = own_all[d], nei_all[d], delta_all[d]
        owned = (own < n_loc) & (nei < n_loc) & (w > 0)
        if levels:
            _, nc, cur_own, cur_nei, _ = levels[-1]
            cur_w = np.ones(len(cur_own))
        else:
            cur_own, cur_nei, cur_w, nc = own[owned], nei[owned], np.ones(
                int(owned.sum())), n_loc
        while len(levels) < L:
            matched, nc_c, own_c, nei_c, w_c, f2cf = fv._amg_pair_level(cur_own, cur_nei,
                                                                       cur_w, nc)
            levels.append((matched, nc_c, own_c, nei_c, f2cf))
            cur_own, cur_nei, cur_w, nc = own_c, nei_c, w_c, nc_c

    aggs_s, owners_s, neighs_s, f2cf_s, sizes = [], [], [], [], []
    for lv in range(L):
        nc_max = max(sh[1][lv][1] for sh in shards)
        nf_max = max(max(len(sh[1][lv][2]), 1) for sh in shards)
        nff_prev = n_int if lv == 0 else sizes[lv - 1][1]
        ncf_prev = c_ext if lv == 0 else sizes[lv - 1][0]
        A = np.full((D, ncf_prev), nc_max, np.int64)      # pad -> dropped
        O = np.zeros((D, nf_max), np.int64)
        N = np.zeros((D, nf_max), np.int64)
        F = np.full((D, nff_prev), -1, np.int64)
        for d, (sel0, levels) in enumerate(shards):
            matched, nc_c, own_c, nei_c, f2cf = levels[lv]
            A[d, : len(matched)] = matched
            if lv == 0:
                A[d, n_loc:c_ext] = nc_max                 # ghosts dropped
                F[d, sel0] = f2cf
            else:
                F[d, : len(f2cf)] = f2cf
            O[d, : len(own_c)] = own_c
            N[d, : len(nei_c)] = nei_c
        aggs_s.append(A)
        owners_s.append(O)
        neighs_s.append(N)
        f2cf_s.append(F)
        sizes.append((int(nc_max), int(nf_max)))

    off_mask = ((own_all < n_loc) & (nei_all < n_loc) & (delta_all > 0)).astype(np.float32)
    return make_local_amg({"aggs": aggs_s, "owners": owners_s, "neighs": neighs_s,
                           "f2cf": f2cf_s, "off_mask": off_mask, "sizes": sizes,
                           "n_levels": L}, smesh)


def _local_coarse_ops(lamg: LocalAmg, s: int, m: fv.FvMesh, diag0, off0):
    """Shard s's Galerkin coarse (diag, off) per level from the local
    (masked) operator; JAX rebuilds them in every V-cycle
    (``_local_vcycle``), the port once per CG solve, as ``fv.amg_cg_solve``
    does.  Padded indices are dropped, as JAX's ``mode="drop"``."""
    t = lamg.shard[s]
    levels = []
    diag, off = diag0, off0
    for lv in range(lamg.n_levels):
        ncl, n_cf = lamg.sizes[lv]
        diag_c = fv.index_sum(ncl, [(t["aggs"][lv], diag), (t["intra_agg"][lv], 2.0 * off)],
                              drop=True)
        diag_c = torch.where(diag_c == 0.0, 1.0, diag_c)     # pad slots
        off_c = fv.index_sum(n_cf, [(t["f2cf"][lv], off)], drop=True)
        levels.append((diag_c, off_c))
        diag, off = diag_c, off_c
    return levels


def _local_vcycle(lamg: LocalAmg, s: int, m: fv.FvMesh, diag0, off0, levels, r0, omega=0.65):
    """One V(1,1) cycle of shard s's hierarchy (JAX ``_local_vcycle``):
    damped Jacobi on every level, 12 sweeps on the coarsest.  On the card
    the level kernels and the tail (``fv.vcycle_levels``: 2t + 1 launches), the
    prolongation gathering the clipped index times ``agg_valid``."""
    t = lamg.shard[s]
    L = lamg.n_levels
    if fv._card_path(r0):
        rows = [amg_ops.row_plan(diag0.shape[0], m.own_i, m.neighbour)] + [
            amg_ops.row_plan(d_.shape[0], o, ne)
            for (d_, _), o, ne in zip(levels, t["owners"], t["neighs"])]
        aggs = [amg_ops.agg_plan(nc, a) for (nc, _), a in zip(lamg.sizes, t["aggs"])]
        ops = [(diag0, off0)] + list(levels)
        return fv.vcycle_levels(rows, aggs, ops, list(zip(t["aggs_c"], t["agg_valid"])), r0,
                                omega)

    def matvec_l(li, x):
        if li == 0:
            return fv._sym_matvec(diag0, off0, m.own_i, m.neighbour, x)
        d_, o_ = levels[li - 1]
        return fv._sym_matvec(d_, o_, t["owners"][li - 1], t["neighs"][li - 1], x)

    def descend(li, r):
        d_ = diag0 if li == 0 else levels[li - 1][0]
        x = omega * r / d_
        if li == L:
            for _ in range(12):
                x = x + omega * (r - matvec_l(li, x)) / d_
            return x
        r1 = r - matvec_l(li, x)
        xc = descend(li + 1, fv.index_sum(lamg.sizes[li][0], [(t["aggs"][li], r1)],
                                          drop=True))
        x = x + xc[t["aggs_c"][li]] * t["agg_valid"][li]
        x = x + omega * (r - matvec_l(li, x)) / d_
        return x

    return descend(0, r0)


# ---------------------------------------------------------------------------
# the sharded closures and the Courant number
# ---------------------------------------------------------------------------


def _jacobi1(smesh, As, bs, x0s, n_sweeps):
    """Scalar Jacobi sweeps with a halo refresh per sweep (the closures')."""
    shards = smesh.shards
    inv_d = [1.0 / _safe_diag(sh, A.diag) for sh, A in zip(shards, As)]
    xs = x0s
    for _ in range(n_sweeps):
        xh = halo_refresh(smesh, xs)
        new = []
        for sh, A, b, x, h, iv in zip(shards, As, bs, xs, xh, inv_d):
            m = sh.m
            off = fv.index_sum(x.shape[0], [(m.own_i, A.upper * h[m.neighbour]),
                                            (m.neighbour, A.lower * h[m.own_i])])
            new.append(torch.where(sh.mask, x + iv * (b - (A.diag * x + off)), 0.0))
        xs = new
    return xs


def _velocity_gradient(smesh, uh, u_bcs):
    """Per-shard Gauss gradient of each velocity component [C, 3, 3]."""
    out = []
    for sh, x, bc in zip(smesh.shards, uh, u_bcs):
        gr = [fv.gradient(sh.m, x[:, c], fv.BoundaryCoeffs(a=bc.a, b=bc.b[:, c : c + 1]))
              for c in range(3)]
        out.append(torch.stack(gr, dim=1))
    return out


def make_sharded_keps(smesh: ShardedFlowMesh, nu: float, n_sweeps: int = 6):
    """The transient k-epsilon update over the shards (JAX
    ``make_sharded_keps``, mirroring ``turbulence.k_epsilon_step`` in dt
    mode): production from the halo-refreshed velocity gradient, eddy
    diffusivity faces from the halo-refreshed nut, implicit sinks, log-law
    wall pins on the local wall cells, Jacobi sweeps with a refresh each.
    ``step(smesh, k, eps, nut, u, flux, u_bcs, k_bcs, e_bcs, wall_cell,
    y_wall, dt) -> (k, eps, nut)``."""
    from ..models import turbulence as turb

    def step(sm, k, eps, nut, u, flux, u_bcs, k_bcs, e_bcs, wall_cell, y_wall, dt):
        shards = sm.shards
        n_int = sm.fv_meta[2]
        k = [torch.clamp(x, min=turb.SMALL) for x in k]
        eps = [torch.clamp(x, min=turb.SMALL) for x in eps]
        uh = halo_refresh(sm, u)
        pk = []
        for g, nt in zip(_velocity_gradient(sm, uh, u_bcs), nut):
            s_ = 0.5 * (g + g.transpose(1, 2))
            pk.append(nt * 2.0 * torch.sum(s_ * s_, dim=(1, 2)))
        dt_t = torch.as_tensor(dt, dtype=k[0].dtype)
        ddt = [torch.where(sh.mask, sh.m.vol / dt_t.to(sh.device), 0.0) for sh in shards]
        nut_h = halo_refresh(sm, nut)
        Ae, src_e = [], []
        for sh, kk, ee, nh, f, bc, wc0, yw, p_, dd in zip(shards, k, eps, nut_h, flux, e_bcs,
                                                           wall_cell, y_wall, pk, ddt):
            m, vol = sh.m, sh.m.vol
            big = torch.tensor(1e30, dtype=kk.dtype, device=sh.device)
            valid = yw > 0.0
            gamma_e = nu + turb._div(torch.cat([fv.face_interp(m, nh), nh[m.own_b]]),
                                     turb.SIGMA_EPS)
            A = fv.assemble_transport(m, f, gamma_e, bc, 1, ddt_coeff=dd,
                                      phi_old=ee[:, None])
            diag = A.diag + turb.C2 * (ee / kk) * vol
            src = A.source[:, 0] + turb.C1 * p_ * (ee / kk) * vol
            ew = turb.CMU ** 0.75 * torch.clamp(kk[torch.clamp(wc0, min=0)],
                                                min=turb.SMALL) ** 1.5 / (
                turb.KAPPA * torch.clamp(yw, min=turb.SMALL))
            diag = fv.index_sum(m.n_cells, [(wc0, torch.where(valid, big, 0.0))], out=diag,
                                drop=True)
            src = fv.index_sum(m.n_cells, [(wc0, torch.where(valid, big * ew, 0.0))], out=src,
                               drop=True)
            Ae.append(dataclasses.replace(A, diag=diag))
            src_e.append(torch.where(sh.mask, src, 0.0))
        eps_new = _jacobi1(sm, Ae, src_e, [x * sh.maskf for x, sh in zip(eps, shards)],
                           n_sweeps)
        eps_new = [torch.where(sh.mask, torch.clamp(x, min=turb.SMALL), 0.0)
                   for sh, x in zip(shards, eps_new)]
        Ak, src_k = [], []
        for sh, kk, en, nh, f, bc, p_, dd in zip(shards, k, eps_new, nut_h, flux, k_bcs, pk,
                                                 ddt):
            m, vol = sh.m, sh.m.vol
            gamma_k = nu + turb._div(torch.cat([fv.face_interp(m, nh), nh[m.own_b]]),
                                     turb.SIGMA_K)
            A = fv.assemble_transport(m, f, gamma_k, bc, 1, ddt_coeff=dd, phi_old=kk[:, None])
            Ak.append(dataclasses.replace(
                A, diag=A.diag + (en / torch.clamp(kk, min=turb.SMALL)) * vol))
            src_k.append(torch.where(sh.mask, A.source[:, 0] + p_ * vol, 0.0))
        k_new = _jacobi1(sm, Ak, src_k, [x * sh.maskf for x, sh in zip(k, shards)], n_sweeps)
        k_new = [torch.where(sh.mask, torch.clamp(x, min=turb.SMALL), 0.0)
                 for sh, x in zip(shards, k_new)]
        nut_new = [torch.where(sh.mask, torch.clamp(
            turb.CMU * kn * kn / torch.clamp(en, min=turb.SMALL), 0.0, 1e5), 0.0)
            for sh, kn, en in zip(shards, k_new, eps_new)]
        return k_new, eps_new, nut_new

    return step


def make_sharded_sst(smesh: ShardedFlowMesh, nu: float, n_sweeps: int = 6):
    """The transient k-omega SST update over the shards (JAX
    ``make_sharded_sst``, mirroring ``turbulence.k_omega_sst_step`` in dt
    mode): Menter 2003 blending from the sharded wall distance,
    cross-diffusion from halo-refreshed k/omega gradients, the
    strain-rate-limited eddy viscosity, omegaWallFunction pins on the local
    wall cells.  ``step(smesh, k, w, nut, y, u, flux, u_bcs, k_bcs, w_bcs,
    wall_cell, y_wall, dt) -> (k, w, nut)``."""
    from ..models import turbulence as turb

    def step(sm, k, w, nut, y, u, flux, u_bcs, k_bcs, w_bcs, wall_cell, y_wall, dt):
        shards = sm.shards
        hx = lambda xs: halo_refresh(sm, xs)  # noqa: E731
        k = [torch.clamp(x, min=turb.SMALL) for x in k]
        w = [torch.clamp(x, min=turb.SMALL) for x in w]
        uh = hx(u)
        kh, wh = hx(k), hx(w)
        dt_t = torch.as_tensor(dt, dtype=k[0].dtype)
        per = []
        for sh, g, kk, ww, yy, khs, whs, kb, wb in zip(
                shards, _velocity_gradient(sm, uh, u_bcs), k, w, y, kh, wh, k_bcs, w_bcs):
            m = sh.m
            y_c = torch.clamp(yy, min=1e-10)
            y2 = y_c * y_c
            s_ = 0.5 * (g + g.transpose(1, 2))
            s2 = 2.0 * torch.sum(s_ * s_, dim=(1, 2))
            gk = fv.gradient(m, khs, kb)
            gw = fv.gradient(m, whs, wb)
            cd_kw = 2.0 * turb.ALPHA_W2 * torch.sum(gk * gw, dim=1) / ww
            cd_kw_plus = torch.clamp(cd_kw, min=1e-10)
            sqk = torch.sqrt(kk)
            arg1 = torch.clamp(torch.minimum(
                torch.maximum(sqk / (turb.BETA_STAR * ww * y_c), 500.0 * nu / (y2 * ww)),
                4.0 * turb.ALPHA_W2 * kk / (cd_kw_plus * y2)), max=10.0)
            f1 = torch.tanh(arg1 ** 4)
            arg2 = torch.clamp(torch.maximum(2.0 * sqk / (turb.BETA_STAR * ww * y_c),
                                             500.0 * nu / (y2 * ww)), max=100.0)
            f2 = torch.tanh(arg2 * arg2)
            nut_l = turb.A1_SST * kk / torch.maximum(turb.A1_SST * ww,
                                                     turb.B1_SST * f2 * torch.sqrt(s2))
            pk = torch.minimum(nut_l * s2, turb.C1_SST * turb.BETA_STAR * kk * ww)
            blend = lambda c1_, c2_: f1 * c1_ + (1.0 - f1) * c2_  # noqa: E731
            per.append(dict(s2=s2, cd_kw=cd_kw, f1=f1, f2=f2, nut_l=nut_l, pk=pk,
                            alpha_k=blend(turb.ALPHA_K1, turb.ALPHA_K2),
                            alpha_w=blend(turb.ALPHA_W1, turb.ALPHA_W2),
                            beta=blend(turb.BETA1, turb.BETA2),
                            gamma=blend(turb.GAMMA1, turb.GAMMA2),
                            ddt=torch.where(sh.mask, m.vol / dt_t.to(sh.device), 0.0)))

        def gamma_faces(coefs):
            ch = hx(coefs)
            return [nu + torch.cat([fv.face_interp(sh.m, c), c[sh.m.own_b]])
                    for sh, c in zip(shards, ch)]

        # omega equation
        g_w = gamma_faces([q["alpha_w"] * q["nut_l"] for q in per])
        Aw, src_w = [], []
        for sh, q, gw_, f, bc, ww, kk, wc0, yw in zip(shards, per, g_w, flux, w_bcs, w, k,
                                                      wall_cell, y_wall):
            m, vol = sh.m, sh.m.vol
            big = torch.tensor(1e30, dtype=kk.dtype, device=sh.device)
            valid = yw > 0.0
            A = fv.assemble_transport(m, f, gw_, bc, 1, ddt_coeff=q["ddt"], phi_old=ww[:, None])
            diag = A.diag + q["beta"] * ww * vol
            src = A.source[:, 0] + (q["gamma"] * q["s2"] + (1.0 - q["f1"]) * q["cd_kw"]) * vol
            ywc = torch.clamp(yw, min=1e-10)
            kw_ = torch.clamp(kk[torch.clamp(wc0, min=0)], min=turb.SMALL)
            w_vis = 6.0 * nu / (turb.BETA1 * ywc * ywc)
            w_log = torch.sqrt(kw_) / (turb.CMU ** 0.25 * turb.KAPPA * ywc)
            w_wall = torch.sqrt(w_vis * w_vis + w_log * w_log)
            diag = fv.index_sum(m.n_cells, [(wc0, torch.where(valid, big, 0.0))], out=diag,
                                drop=True)
            src = fv.index_sum(m.n_cells, [(wc0, torch.where(valid, big * w_wall, 0.0))],
                               out=src, drop=True)
            Aw.append(dataclasses.replace(A, diag=diag))
            src_w.append(torch.where(sh.mask, src, 0.0))
        w_new = _jacobi1(sm, Aw, src_w, [x * sh.maskf for x, sh in zip(w, shards)], n_sweeps)
        w_new = [torch.where(sh.mask, torch.clamp(x, min=turb.SMALL), 0.0)
                 for sh, x in zip(shards, w_new)]

        # k equation
        g_k = gamma_faces([q["alpha_k"] * q["nut_l"] for q in per])
        Ak, src_k = [], []
        for sh, q, gk_, f, bc, kk, wn in zip(shards, per, g_k, flux, k_bcs, k, w_new):
            m, vol = sh.m, sh.m.vol
            A = fv.assemble_transport(m, f, gk_, bc, 1, ddt_coeff=q["ddt"], phi_old=kk[:, None])
            Ak.append(dataclasses.replace(A, diag=A.diag + turb.BETA_STAR * torch.clamp(
                wn, min=turb.SMALL) * vol))
            src_k.append(torch.where(sh.mask, A.source[:, 0] + q["pk"] * vol, 0.0))
        k_new = _jacobi1(sm, Ak, src_k, [x * sh.maskf for x, sh in zip(k, shards)], n_sweeps)
        k_new = [torch.where(sh.mask, torch.clamp(x, min=turb.SMALL), 0.0)
                 for sh, x in zip(shards, k_new)]
        nut_new = [torch.where(sh.mask, torch.clamp(
            turb.A1_SST * kn / torch.maximum(turb.A1_SST * torch.clamp(wn, min=turb.SMALL),
                                             turb.B1_SST * q["f2"] * torch.sqrt(q["s2"])),
            0.0, 1e5), 0.0) for sh, kn, wn, q in zip(shards, k_new, w_new, per)]
        return k_new, w_new, nut_new

    return step


def courant_number(smesh: ShardedFlowMesh, flux, dt):
    """The sharded max Courant number (CourantNo.H; JAX ``make_courant``), a
    pmax over the shards: a 0-dim tensor on shard 0's device."""
    cos = []
    for sh, f in zip(smesh.shards, flux):
        m = sh.m
        sums = fv.index_sum(m.n_cells, [(m.owner, torch.abs(f)),
                                        (m.neighbour, torch.abs(f[: m.n_internal]))])
        cos.append(0.5 * dt * torch.max(torch.where(sh.mask, sums / m.vol, 0.0)))
    return pmax(cos)


# ---------------------------------------------------------------------------
# the solver the coupled driver runs
# ---------------------------------------------------------------------------


class ShardedFlowSolver:
    """Drop-in for ``models/pimple.FlowSolver`` running the PIMPLE step
    domain-decomposed over ``n_dev`` shards: the product path behind
    ``coupled --flow-devices N`` (the reference's ``Allrun-parallel``).
    Laminar, kEpsilon (the reference's parallel tutorial closure,
    ``TJunction/constant/turbulenceProperties:21-27``) and kOmegaSST, MRF
    zones, momentum fvOptions, the p0 tables and solid-body/Laplacian
    dynamic meshes (the motion runs host-side, the per-shard geometry
    re-scatters, correctPhi is a psum-global CG).

    ``device`` (default the case mesh's device, else the card) as
    ``FlowSolver.from_case``, the shards on ``make_device_mesh(n_dev,
    device)``; ``dtype`` default float32.  Unlike JAX's,
    which always starts at t = 0 from ``0/``, the solver starts at the
    case's time and fields (a latestTime restart), as ``FlowSolver``
    does."""

    def __init__(self, case, n_dev: int, log=print, dtype=None, device=None, **cfg_kw):
        import time as _time

        from ..models import dynamicmesh as dyn_mod
        from ..models import fvoptions as fvo_mod
        from ..models import mrf as mrf_mod
        from ..models.pimple import PimpleConfig
        from ..models.simple import load_flow_case, read_numerics, turbulence_model

        if device is None:
            tm = getattr(case, "tet_mesh", None)
            device = tm.device if tm is not None else None
        device = canonical_device(device)
        self.devices = tuple(make_device_mesh(n_dev, device))
        dev0 = self.devices[0]
        time_dir = getattr(case, "time_dir", "0")
        m, st, u_bcs, p_bcs, nu, pin, p_tables = load_flow_case(
            case.case_dir, pm=case.poly, dtype=dtype, time_dir=time_dir, device=dev0)
        num = read_numerics(case.case_dir)
        for key in ("div_scheme", "n_correctors", "n_nonortho", "n_outer"):
            cfg_kw.setdefault(key, num[key])
        cfg_kw.setdefault("p_solver", "amg")
        self.cfg = PimpleConfig(nu=nu, pin_pressure=pin, **cfg_kw)
        self.m = m
        self.log = log
        grid = read_decompose_par(case.case_dir, n_dev, log=log)
        h0 = _time.perf_counter()
        self.smesh, self.bglob = decompose(case.poly, n_dev, dtype=m.dtype, grid=grid,
                                           devices=self.devices)
        self.decompose_s = _time.perf_counter() - h0
        self.p_bcs = p_bcs
        self.p_tables = p_tables
        self.time = case.time_value
        self.last = {}
        self._state = None            # the gathered state, until the next step

        # MRF zones: the rotating-wall velocity folded into the GLOBAL u BCs
        # (omega is constant); Coriolis and the relative flux run in the step
        self.mrf = mrf_mod.from_case(case.case_dir, m, case.poly)
        if self.mrf is not None:
            u_bcs = mrf_mod.correct_boundary_velocity(self.mrf, m, u_bcs)
            self.mrf_omega_s, self.mrf_flux_s = shard_mrf(self.smesh, self.mrf, m)
        self.u_bcs = u_bcs

        # momentum fvOptions: su/sp/zone mask per shard, the meanVelocityForce
        # parameters and gradP state on shard 0's device
        self.fvo = fvo_mod.from_case(case.case_dir, m, case.poly)
        if self.fvo is not None:
            self.fvo_su_s = scatter_cells(self.smesh, self.fvo.su)
            self.fvo_sp_s = scatter_cells(self.smesh, self.fvo.sp)
            self.fvo_mask_s = scatter_cells(self.smesh, self.fvo.mvf_mask)
            log("#flow: sharded momentum fvOptions active"
                + (" (meanVelocityForce)" if self.fvo.has_mvf else ""))

        self.u_bcs_s = shard_bcs(u_bcs, self.bglob, self.smesh)
        self.p_bcs_s = shard_bcs(p_bcs, self.bglob, self.smesh)
        self.u_s = scatter_cells(self.smesh, st.u)
        self.p_s = scatter_cells(self.smesh, st.p)
        self.flux_s = flux_init(self.smesh, self.u_s, self.u_bcs_s)
        if self.mrf is not None:
            # the convective flux is stored RELATIVE to the frame
            self.flux_s = [f - ff for f, ff in zip(self.flux_s, self.mrf_flux_s)]
        if case.time_value > 0.0:
            self._restart_flux(case, time_dir)

        # dynamic mesh: the host-side motion, the per-shard geometry
        # re-scattered, the flux rebuilt and projected by the sharded
        # correctPhi, then made relative to meshPhi
        self.dyn = None
        self.moving_patches = ()
        motion = dyn_mod.read_dynamic_mesh(case.case_dir)
        if motion is not None:
            from ..io import polymesh as polymesh_io

            self.dyn = dyn_mod.DynamicMesh(motion, case.poly, dtype=m.dtype, device=dev0)
            u0 = os.path.join(case.case_dir, "0", "U")
            bcs0 = polymesh_io.read_field_bcs(u0) if os.path.exists(u0) else {}
            self.moving_patches = tuple(k for k, e in bcs0.items()
                                        if e[0] == "movingWallVelocity")
            log(f"#flow: sharded dynamic mesh: {motion.kind} "
                f"(moving walls: {self.moving_patches})")

        self.turb_model = turbulence_model(case.case_dir)
        self._turb_on = False
        if self.turb_model in ("kEpsilon", "kOmegaSST"):
            self._init_turbulence(case, m, nu, time_dir, log)
        elif self.turb_model != "laminar":
            raise NotImplementedError(
                f"turbulence model {self.turb_model!r} is not supported by the sharded flow "
                "solver; run the flow single-device")
        # the additive-Schwarz AMG preconditioner of the pressure CG
        h0 = _time.perf_counter()
        self.lamg = build_local_amg(self.smesh) if self.cfg.p_solver == "amg" else None
        self.amg_s = _time.perf_counter() - h0
        self._step = make_sharded_pimple(
            self.smesh, self.cfg, with_turb=self._turb_on, lamg=self.lamg,
            with_mrf=self.mrf is not None, with_fvo=self.fvo is not None,
            fvo_mvf=self.fvo is not None and self.fvo.has_mvf)
        log(f"#flow: sharded PIMPLE on {n_dev} devices "
            f"[{placement(self.devices)}], {case.poly.n_cells} cells "
            f"({self.smesh.n_loc}/shard, {self.smesh.halo_stats()['rounds']} halo rounds), "
            f"nu={nu}" + (f", {self.turb_model} closure" if self._turb_on else ""))

    def _restart_flux(self, case, time_dir):
        """A restart's flux: the written phi where there is one, else the
        U-rebuilt flux projected by the sharded correctPhi (as
        ``FlowSolver.from_case``)."""
        from ..io import polymesh as pmio

        phi = pmio.read_surface_field(os.path.join(case.case_dir, time_dir, "phi"),
                                      case.poly.patches)
        if phi is not None and len(phi) == self.m.n_faces:
            self.flux_s = scatter_faces(self.smesh, np.asarray(phi))
            self.log("#flow: restart flux from written phi")
        else:
            self.flux_s, res_c = correct_flux(self.smesh, self.flux_s, self.p_bcs_s,
                                              pin=self.cfg.pin_pressure)
            self.log(f"#flow: sharded correctPhi residual={float(res_c):.3e}")

    def _wall_arrays(self, wi):
        """Per-shard wall arrays (local boundary slot, local owner cell, wall
        distance) from the global wall_info; returns the wall-face count."""
        m = self.m
        n_bd_g = m.n_faces - m.n_internal
        y_of = np.full(n_bd_g, -1.0)
        y_of[fv.host(wi.wall_bd_face)] = fv.host(wi.y_wall)
        bg = self.bglob
        nf_int_l = self.smesh.fv_meta[2]
        own_l = self.smesh.owner[:, nf_int_l:]
        D, B = bg.shape
        wc = np.full((D, B), -1, np.int64)
        yw = np.full((D, B), -1.0)
        wb = np.full((D, B), -1, np.int64)
        for d in range(D):
            sel = (bg[d] >= 0) & (y_of[np.clip(bg[d], 0, n_bd_g - 1)] > 0.0)
            wc[d, sel] = own_l[d, sel]
            yw[d, sel] = y_of[bg[d, sel]]
            wb[d, sel] = np.nonzero(sel)[0]
        self.wall_cell_s = _put(self.smesh, wc)
        self.y_wall_s = _put(self.smesh, yw)
        self.wall_bd_s = _put(self.smesh, wb)
        return int((yw > 0).sum())

    def _init_turbulence(self, case, m, nu, time_dir, log):
        """Scatter the closure fields and build the per-shard wall arrays."""
        from ..models import turbulence as turb

        st, bcs_a, bcs_b, wi = turb.init_model(self.turb_model, case.case_dir, m,
                                               time_dir=time_dir)
        second = "eps" if self.turb_model == "kEpsilon" else "omega"
        self.k_s = scatter_cells(self.smesh, st.k)
        self.e_s = scatter_cells(self.smesh, getattr(st, second))
        self.nut_s = scatter_cells(self.smesh, st.nut)
        self.y_s = scatter_cells(self.smesh, st.y) if second == "omega" else None
        self.k_bcs_s = shard_bcs(bcs_a, self.bglob, self.smesh)
        self.e_bcs_s = shard_bcs(bcs_b, self.bglob, self.smesh)
        n_wall = self._wall_arrays(wi)
        self._closure = (make_sharded_keps(self.smesh, nu) if second == "eps"
                         else make_sharded_sst(self.smesh, nu))
        self._turb_on = True
        log(f"#flow: sharded {self.turb_model} ({n_wall} wall faces)")

    def _apply_p_tables(self, t: float):
        """Time-varying pressure-BC tables (uniformTotalPressure p0 ramps, as
        ``FlowSolver._apply_p_tables``) into the global p BCs, re-sharded."""
        if self.p_tables:
            bcs = p_table_bcs(self.p_bcs, self.p_tables, self.m.patch_slices, t)
            self.p_bcs_s = shard_bcs(bcs, self.bglob, self.smesh)

    def move_mesh(self, dt_e: float):
        """The sharded ``mesh.controlledUpdate()`` + correctPhi + makeRelative
        (``cudaParticlesPimpleFoam.C:144-166``).  The local AMG keeps its
        initial-geometry hierarchy (the pairing is topological)."""
        from ..models import dynamicmesh as dyn_mod

        m_new, mesh_phi, bd_vel = self.dyn.update(self.time, dt_e)
        self.m = m_new
        self.u_bcs = dyn_mod.update_moving_wall_bcs(m_new, self.u_bcs, bd_vel,
                                                    self.moving_patches)
        self.u_bcs_s = shard_bcs(self.u_bcs, self.bglob, self.smesh)
        self.smesh = refresh_sharded_geometry(self.smesh, m_new)
        n_int = self.smesh.fv_meta[2]
        u_bcs_e = [fv.effective_bcs(bc, f[n_int:]) for bc, f in zip(self.u_bcs_s, self.flux_s)]
        phi_abs = flux_init(self.smesh, self.u_s, u_bcs_e)
        phi_abs, res_c = correct_flux(self.smesh, phi_abs, self.p_bcs_s, pin=self.cfg.pin_pressure)
        self.log(f"#flow: sharded correctPhi residual={float(res_c):.3e}")
        self.flux_s = [a - b for a, b in zip(phi_abs, scatter_faces(self.smesh, mesh_phi))]

    def advance(self, dt_e: float):
        """One Eulerian step of ``dt_e``; logs JAX's sharded residual line
        and returns the residuals as floats, with ``p_iters`` the CG
        iterations of every pressure solve."""
        self.time = self.time + dt_e
        self._apply_p_tables(self.time)
        if self.dyn is not None:
            self.move_mesh(dt_e)
        args = [self.smesh, self.u_s, self.p_s, self.flux_s, self.u_bcs_s, self.p_bcs_s, dt_e]
        if self.lamg is not None:
            args.append(self.lamg)
        if self.mrf is not None:
            args += [self.mrf_omega_s, self.mrf_flux_s]
        if self.fvo is not None:
            f = self.fvo
            par = torch.cat([f.mvf_dir, torch.stack([f.mvf_mag, f.mvf_relax, f.grad_p, f.dgrad])])
            args += [self.fvo_su_s, self.fvo_sp_s, self.fvo_mask_s, par]
        if self._turb_on:
            args += [self.nut_s, self.k_s, self.wall_cell_s, self.y_wall_s, self.wall_bd_s]
        self.u_s, self.p_s, self.flux_s, diag = self._step(*args)
        self._state = None
        if self.fvo is not None:
            self.fvo = dataclasses.replace(self.fvo, grad_p=diag["fvo_grad_p"],
                                           dgrad=diag["fvo_dgrad"])
        if self._turb_on:
            if self.turb_model == "kOmegaSST":
                self.k_s, self.e_s, self.nut_s = self._closure(
                    self.smesh, self.k_s, self.e_s, self.nut_s, self.y_s, self.u_s,
                    self.flux_s, self.u_bcs_s, self.k_bcs_s, self.e_bcs_s, self.wall_cell_s,
                    self.y_wall_s, dt_e)
            else:
                self.k_s, self.e_s, self.nut_s = self._closure(
                    self.smesh, self.k_s, self.e_s, self.nut_s, self.u_s, self.flux_s,
                    self.u_bcs_s, self.k_bcs_s, self.e_bcs_s, self.wall_cell_s,
                    self.y_wall_s, dt_e)
        # the one host read of the step's residuals
        u_res, p_res, cont = torch.stack(
            [diag["u_res"], diag["p_res"], diag["continuity"]]).tolist()
        self.last = {"u_res": u_res, "p_res": p_res, "continuity": cont}
        self.log(f"#flow: U residual={u_res:.3e} p residual={p_res:.3e} "
                 f"continuity={cont:.3e} (sharded)")
        return {**self.last, "p_iters": diag["p_iters"]}

    @property
    def kes(self):
        """The gathered closure state (None when laminar): the coupled
        driver writes the k/epsilon (or k/omega) restart fields from it."""
        if not self._turb_on:
            return None
        from ..models import turbulence as turb

        nc = self.m.n_cells
        g = lambda xs: gather_cells(self.smesh, xs, nc)  # noqa: E731
        if self.turb_model == "kOmegaSST":
            return turb.KOmegaSSTState(k=g(self.k_s), omega=g(self.e_s), nut=g(self.nut_s),
                                       y=g(self.y_s))
        return turb.KEpsilonState(k=g(self.k_s), eps=g(self.e_s), nut=g(self.nut_s))

    def stable_dt(self, ctrl):
        """maxCo-scaled time step (setDeltaT semantics) from the pmax'd
        Courant number, read on the host."""
        return courant_dt(ctrl, float(courant_number(self.smesh, self.flux_s, ctrl.delta_t)))

    @property
    def state(self) -> FlowState:
        """The gathered global state on shard 0's device (gathered once a
        step); the face flux is the shard-local CORRECTED flux through the
        signed global-face map (conservative)."""
        if self._state is None:
            self._state = FlowState(
                u=gather_cells(self.smesh, self.u_s, self.m.n_cells),
                p=gather_cells(self.smesh, self.p_s, self.m.n_cells),
                flux=gather_faces(self.smesh, self.flux_s, self.m.n_faces))
        return self._state

    def cell_velocity(self) -> np.ndarray:
        return fv.host(self.state.u)
