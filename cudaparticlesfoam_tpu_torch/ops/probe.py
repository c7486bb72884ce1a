"""The latency of one dependent load on the card, the unit of the rare
kernels' bound (``traffic.latency_bound``): wrappers of the measuring
kernel ``chase_kernel`` (``csrc/probe.cu``); and the units of the AMG
tail's bound (``traffic.amg_latency_bound``): the cost of one cluster
barrier, :func:`cluster_sync` (``cluster_sync_kernel``), and the latency of
a dependent read of shared memory, a block's own or another block's of the
cluster, :func:`smem_chase` (``smem_chase_kernel``).  The port never calls
them; ``chip_smoke.py`` times them (phases 6 and 14) to price the kernels'
chains and phases.

Each call follows a chain of ``steps`` loads with one thread, each address
taken from the value the load before returned, and keeps the chain's
position in ``state`` [2] int32 (position, hash), so a later call walks on
from there.  :func:`chase_neighbours` walks the neighbour codes of a row
table (the locality a rare kernel's walk has); :func:`chase_permutation`
walks a random single-cycle permutation over a buffer as large as the
table (each step a random line).

On CPU tensors a host loop stands in (the plain version); its time says
nothing about a device.
"""

from __future__ import annotations

import torch

from . import _build

STEPS = 4096
_MASK = 0xFFFFFFFF


def _next_hash(h: int) -> int:
    """``csrc/probe.cu:next_hash``: a 32-bit LCG; the face is its top two bits."""
    return (h * 1664525 + 1013904223) & _MASK


def _as_int32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def _check_state(state, dev):
    if (not torch.is_tensor(state) or state.dtype != torch.int32 or state.shape != (2,)
            or state.device != dev or not state.is_contiguous()):
        raise ValueError(f"state must be a contiguous int32 [2] tensor on {dev}")


def _launch(entry, args, dev, what):
    lib = _build.library()
    err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        _build.check(lib, err, what)


def chase_neighbours(tab, nbr, steps, state):
    """Follow ``steps`` dependent loads through the neighbour codes of
    ``tab`` [nt, w] (float32, codes at columns ``nbr`` .. ``nbr`` + 3):
    from tet ``state[0]`` with hash ``state[1]``, each step hashes, takes
    face ``hash >> 30`` and moves to that neighbour, or stays on a wall
    code (< 0).  Updates ``state``."""
    if tab.dtype != torch.float32 or tab.dim() != 2 or not tab.is_contiguous():
        raise ValueError("tab must be a contiguous float32 [nt, w] table")
    if not 0 <= nbr <= tab.shape[1] - 4 or steps < 0:
        raise ValueError(f"bad nbr {nbr} or steps {steps}")
    _check_state(state, tab.device)
    if tab.device.type == "cpu":
        codes = tab[:, nbr : nbr + 4].to(torch.int64).tolist()
        at, h = int(state[0]), int(state[1]) & _MASK
        for _ in range(steps):
            h = _next_hash(h)
            code = codes[at][h >> 30]
            at = code if code >= 0 else at
        state.copy_(torch.tensor([at, _as_int32(h)], dtype=torch.int32))
        return
    _launch("cpf_chase_nbr", (tab.data_ptr(), tab.shape[1], nbr, steps, state.data_ptr()),
            tab.device, "chase_kernel<0>")


def permutation(n, seed, device):
    """A random permutation of ``n`` lanes with one cycle through all of
    them, as ``next`` [n] int32 (i -> next[i])."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    order = torch.randperm(n, generator=g, device=device)
    nxt = torch.empty(n, dtype=torch.int32, device=device)
    nxt[order] = order.roll(-1).to(torch.int32)
    return nxt


def chase_permutation(nxt, steps, state):
    """Follow ``steps`` dependent loads ``at = nxt[at]`` from ``state[0]``;
    updates ``state``."""
    if nxt.dtype != torch.int32 or nxt.dim() != 1 or not nxt.is_contiguous() or steps < 0:
        raise ValueError("nxt must be a contiguous int32 [n] tensor, steps >= 0")
    _check_state(state, nxt.device)
    if nxt.device.type == "cpu":
        table = nxt.tolist()
        at = int(state[0])
        for _ in range(steps):
            at = table[at]
        state[0] = at
        return
    _launch("cpf_chase_perm", (nxt.data_ptr(), steps, state.data_ptr()), nxt.device,
            "chase_kernel<1>")


CLUSTER_BLOCKS = 16      # the AMG tail's cluster (csrc/amg.cu TAIL_BLOCKS)
CHASE_SLOTS = 1024       # csrc/probe.cu: smem_chase_kernel's cycle


BARRIER_MODES = ("release", "relaxed", "one release")    # csrc/probe.cu cluster_sync_kernel<MODE>


def cluster_sync(syncs, threads, state, mode="release", blocks=CLUSTER_BLOCKS):
    """One cluster of ``blocks`` (2 to 16; the AMG tail's: 16) blocks of
    ``threads`` each passes ``syncs`` cluster barriers: ``mode`` "release"
    (release/acquire in every thread, the earlier tail's), "relaxed" (an arrive
    without memory ordering: only the fence's price) or "one release" (the
    tail's: __syncthreads, warp 0's release, every thread's acquire); each
    block then adds ``syncs`` to ``state[rank]`` (int32 [16]).  On the CPU
    only the count is added."""
    if (not torch.is_tensor(state) or state.dtype != torch.int32
            or state.shape != (CLUSTER_BLOCKS,) or not state.is_contiguous()):
        raise ValueError(f"state must be a contiguous int32 [{CLUSTER_BLOCKS}] tensor")
    if syncs < 0 or not 1 <= threads <= 512 or mode not in BARRIER_MODES \
            or not 1 <= blocks <= CLUSTER_BLOCKS:
        raise ValueError(f"bad syncs {syncs}, threads {threads}, mode {mode!r} or blocks {blocks}")
    if state.device.type == "cpu":
        state[:blocks] += syncs
        return
    _launch("cpf_cluster_sync", (syncs, threads, BARRIER_MODES.index(mode), blocks,
                                 state.data_ptr()), state.device, "cluster_sync_kernel")


def smem_chase(steps, state, remote=False):
    """Follow ``steps`` dependent shared-memory loads ``j = (389 j + 1) mod
    1024`` from ``state[0]`` mod 1024 in one cluster of 16 blocks: in block
    0's own shared memory, or with ``remote`` each in another block's
    (distributed shared memory); leaves where it stopped in ``state[0]``
    (int32 [2])."""
    _check_state(state, getattr(state, "device", None))
    if steps < 0:
        raise ValueError(f"bad steps {steps}")
    if state.device.type == "cpu":
        j = int(state[0]) & (CHASE_SLOTS - 1)
        for _ in range(steps):
            j = (389 * j + 1) % CHASE_SLOTS
        state[0] = j
        return
    _launch("cpf_smem_chase", (steps, int(remote), state.data_ptr()), state.device,
            "smem_chase_kernel")
