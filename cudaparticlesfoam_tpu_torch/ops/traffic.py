"""Bytes each CUDA kernel of the port must move per call, and its bound.

A kernel's bound is the least time the card could take for the same work:
the larger of its bytes over the memory rate and its operations over the
peak rate (``bound_ms``).  Each input byte is counted once and each output
byte once, whatever the kernel reads again; where the work depends on the
data (lanes that hop, cross, stay pending or keep working), the caller
passes the counts of the run at hand, so the bound is what those inputs
need, not the most a lane could touch.  ``chip_smoke.py`` measures the
counts on the slice and prints each kernel's bytes, bound and share.

Rates are NVIDIA's data-sheet peaks of the H100 SXM at its 700 W limit:
HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.  The
operation counts are hand counts of each kernel's arithmetic per lane
(``OPS``: float operations, the Philox rounds' integer operations counted
alike); at these shapes they are two orders below the bytes, so every
kernel here is bound by bytes.

Kernels (``csrc/``) and what a call moves, per lane of n, with e the
element size (4 for float32, 8 for float64); the mega row is 32 columns,
a bary table row 20 and a cx table row 24.  Under the VertexVelocity
layout (``layout="pk"`` of :func:`stream` and :func:`rare`) the mega row is
40 columns and a table row 32: the kernels read ``fused.row_table``, the
29-column ``tet_row_pk`` padded to 32, and move whole padded rows, so the
pad is counted as what the function is given, not as waste:

* ``stream_kernel``: reads the mega row, xi (3 columns, noise "xi" only),
  the admission byte (pass "admitted") and one table row per hop; writes
  the 8-column head, the cached row of each lane whose row changed (it
  hopped) and the pending byte.  The other rows and the zero pad are left
  as they were, so they are not counted.  Pass "crossers" reads the same
  but hops nowhere, and writes only the flag byte.  Its RK4 instantiation
  (``rk4``) reads on top one table row per hop of each stage walk
  (``stage_rows``; ``fused.stream_plain(stage_walks=...)`` counts them);
  the stage tests run on the cached row the lane already read.
* ``convex_stream_kernel``: reads the mega row, xi, the admission byte and
  one cx row per interior crosser that loads its neighbour; writes the
  8-column head, the cx row of each lane that hopped, disp (3 columns) and
  the pending byte.  Pass "crossers": the flag byte only.
* ``macro_stream_kernel``: reads the phase byte, the admission byte
  (pass "admitted"), the mega row of each working lane (phase < k), xi
  for each sub-step drawn (noise "xi") and one table row per hop; writes
  the head and phase byte of each working lane, the cached row of each
  lane whose row changed, and every pending byte.  Pass "crossers": the
  flag byte of every lane.
* ``hop_admit_kernel``: the crossing flags, the admission flags, and its
  scratch of 32-bit words (2 and one per 8192 lanes) read and written.
  A call this small is bound by launch latency, not by these bytes:
  :func:`share_of_floor` holds its time against the measured time of a
  launch that does next to nothing.
* ``rare_kernel`` and ``convex_rare_kernel``: bound by latency, not by
  bytes.  Their bytes (:func:`rare`, :func:`convex_rare`) are a floor: the
  pending flags, each pending lane's state (read and written) and one new
  row per lane whose tet changed, not the rows the walk passed through.
  Their bound is :func:`latency_bound`: a pending lane is a chain of
  dependent loads (its flag, its own mega row, then the row loads that
  ``fused.rare_chain`` / ``fused_convex.rare_chain`` count), the lanes run
  side by side, so the call lasts at least one launch plus the longest
  chain times the latency of one dependent load (``ops/probe.py``
  measures it on the card).  :func:`share_of_latency` holds the time
  against it.
* the AMG-CG pressure solve's kernels (``csrc/amg.cu``; :func:`amg_matvec`,
  :func:`amg_down`, :func:`amg_up`, :func:`amg_tail`, whose coarsest level
  alone is :func:`amg_coarsest`): each row plan, coefficient and vector a
  call reads once and each result it writes; the neighbours' values that a
  row reads again are not counted, nor the tail's inner levels' r and x,
  which never leave the chip.  At the pitzDaily's sizes these bytes take
  less than a launch: each kernel also has a latency bound
  (:func:`amg_latency_bound`), the launch floor plus its longest chain of
  dependent loads (:data:`AMG_CHAIN`) or, for the tail, its cluster
  barriers and the loads after each that wait on the phase before
  (:func:`amg_tail_chain`).
"""

from __future__ import annotations

import dataclasses

from .fused import LAYOUT_PK, LAYOUT_TET

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
MEGA_W, ROW_W, CX_W, HEAD_W = LAYOUT_TET.width, LAYOUT_TET.tab_w, 24, 8
LAYOUT_NAMES = {"tet": LAYOUT_TET, "pk": LAYOUT_PK}
NOISES = ("xi", "philox", "none")
PASSES = ("whole", "crossers", "admitted")
ADMIT_TILE = 8192        # lanes per block of hop_admit_kernel

# hand counts of arithmetic per lane (csrc/): the sub-step to the hop-0
# test, the bounce block every lane runs, one hop's re-test; a Philox draw
# (10 rounds, the uniforms, 2 log, 2 sqrt, sin, cos)
OPS = {"stream": 110, "stream_hop": 25, "convex": 110, "convex_hop": 70, "philox": 240,
       "macro_step": 45, "rare_lane": 60, "admit_group": 12,
       # the Pk blend: the weights at the current point (21) and 3 x 7
       "pk_blend": 42,
       # an RK4 stage: its point (6), the hop-0 test (24), the velocity (Pk:
       # another blend), and the final sum (4 a component, once a lane)
       "rk4_stage": 30, "rk4_sum": 12}


def _widths(layout):
    """(mega row, table row) widths of a layout name, from ``fused``'s
    layouts: the table row is what a hop moves (``tab_w``)."""
    if layout not in LAYOUT_NAMES:
        raise ValueError(f"layout must be one of {tuple(LAYOUT_NAMES)}, got {layout!r}")
    ly = LAYOUT_NAMES[layout]
    return ly.width, ly.tab_w


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Bytes read and written, and operations, of one kernel call."""

    read: int
    written: int
    ops: int

    @property
    def bytes(self) -> int:
        return self.read + self.written

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.ops / PEAK_OPS_PER_S * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"

    def __add__(self, other: "Traffic") -> "Traffic":
        return Traffic(self.read + other.read, self.written + other.written,
                       self.ops + other.ops)


def _check(n, elem, noise, pass_, *counts):
    if elem not in (4, 8):
        raise ValueError(f"element size must be 4 or 8, got {elem}")
    if noise not in NOISES:
        raise ValueError(f"noise must be one of {NOISES}, got {noise!r}")
    if pass_ not in PASSES:
        raise ValueError(f"pass must be one of {PASSES}, got {pass_!r}")
    if n < 0 or any(c < 0 or c > n for c in counts):
        raise ValueError(f"counts {counts} must lie in [0, n={n}]")


def _noise_ops(noise, draws):
    return OPS["philox"] * draws if noise == "philox" else 0


def stream(n: int, elem: int, noise: str, pass_: str = "whole", hops: int = 0,
           hopped: int = 0, layout: str = "tet", rk4: bool = False,
           stage_rows: int = 0) -> Traffic:
    """``stream_kernel``: ``hops`` table rows loaded (summed over the inline
    hops; 0 in the crossers pass), ``hopped`` lanes whose cached row
    changed (written back).  ``layout`` "pk": the VertexVelocity
    instantiation (40-column mega, 32-column padded table rows, the whole
    pass only).  ``rk4``: the RK4 instantiation (the whole pass only),
    whose three stage walks loaded ``stage_rows`` table rows in all."""
    _check(n, elem, noise, pass_, hopped)
    mega_w, row_w = _widths(layout)
    if stage_rows < 0 or (stage_rows and not rk4):
        raise ValueError(f"stage_rows ({stage_rows}) must be >= 0, and 0 without rk4")
    if (layout == "pk" or rk4) and pass_ != "whole":
        raise ValueError("the VertexVelocity and RK4 streams have the whole pass only")
    if pass_ == "crossers" and hops:
        raise ValueError("the crossers pass does not hop")
    if hopped > hops:
        raise ValueError("a lane's row changes only by a hop")
    read = n * mega_w * elem + hops * row_w * elem
    read += n * 3 * elem if noise == "xi" else 0
    read += n if pass_ == "admitted" else 0
    written = n if pass_ == "crossers" else n * HEAD_W * elem + hopped * row_w * elem + n
    ops = n * OPS["stream"] + hops * OPS["stream_hop"] + _noise_ops(noise, n)
    ops += n * OPS["pk_blend"] if layout == "pk" else 0
    if rk4:
        read += stage_rows * row_w * elem
        stage = OPS["rk4_stage"] + (OPS["pk_blend"] if layout == "pk" else 0)
        ops += n * (3 * stage + OPS["rk4_sum"]) + stage_rows * OPS["stream_hop"]
    return Traffic(read, written, ops)


def convex_stream(n: int, elem: int, noise: str, pass_: str = "whole", row_loads: int = 0,
                  hopped: int = 0) -> Traffic:
    """``convex_stream_kernel``: ``row_loads`` interior crossers that load
    their neighbour's cx row, ``hopped`` of them resolved there (their row
    is written back)."""
    _check(n, elem, noise, pass_, row_loads, hopped)
    if hopped > row_loads:
        raise ValueError("a lane hops only after loading its neighbour's row")
    if pass_ == "crossers" and (row_loads or hopped):
        raise ValueError("the crossers pass does not hop")
    read = n * MEGA_W * elem + row_loads * CX_W * elem
    read += n * 3 * elem if noise == "xi" else 0
    read += n if pass_ == "admitted" else 0
    if pass_ == "crossers":
        written = n
    else:
        written = n * HEAD_W * elem + hopped * CX_W * elem + n * 3 * elem + n
    ops = n * OPS["convex"] + row_loads * OPS["convex_hop"] + _noise_ops(noise, n)
    return Traffic(read, written, ops)


def macro_stream(n: int, elem: int, noise: str, pass_: str = "whole", working: int = 0,
                 substeps: int = 0, hops: int = 0, hopped: int = 0) -> Traffic:
    """One trip of ``macro_stream_kernel``: ``working`` lanes with phase <
    k, ``substeps`` sub-steps they ran in all (noise drawn once each),
    ``hops`` table rows loaded, ``hopped`` lanes whose cached row changed."""
    _check(n, elem, noise, pass_, working, hopped)
    if pass_ == "crossers" and hops:
        raise ValueError("the crossers pass does not hop")
    if hopped > min(hops, working):
        raise ValueError("a lane's row changes only by a hop of a working lane")
    if substeps < 0 or substeps > 8 * working:
        raise ValueError(f"substeps {substeps} must lie in [0, 8 * working]")
    read = n + working * MEGA_W * elem + hops * ROW_W * elem
    read += substeps * 3 * elem if noise == "xi" else 0
    read += n if pass_ == "admitted" else 0
    written = n
    if pass_ != "crossers":
        written += working * HEAD_W * elem + hopped * ROW_W * elem + working
    ops = (substeps * OPS["macro_step"] + working * (OPS["stream"] - OPS["macro_step"])
           + hops * OPS["stream_hop"] + _noise_ops(noise, substeps))
    return Traffic(read, written, ops)


def hop_admit(n: int) -> Traffic:
    """``hop_admit_kernel``: the crossing flags and the zeroed scratch in,
    the admission flags and the scratch (statuses, then zeroed again)
    out; the scratch is 2 words and one per tile of 8192 lanes."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    words = 2 + -(-n // ADMIT_TILE)
    return Traffic(n + 4 * words, n + 4 * words, -(-n // 4) * OPS["admit_group"])


def share_of_floor(bound_ms: float, launch_floor_ms: float, ms: float) -> float:
    """Share of the floor that binds a small call: its bound or the time
    of a launch that does next to nothing (measured on the card,
    ``chip_smoke.py``), whichever is larger, over the call's time."""
    if ms <= 0 or bound_ms < 0 or launch_floor_ms < 0:
        raise ValueError("times must be positive")
    return max(bound_ms, launch_floor_ms) / ms


def rare(n: int, elem: int, pending: int, moved: int, layout: str = "tet") -> Traffic:
    """``rare_kernel``, a floor: ``pending`` lanes read and write pos, vel,
    tet and their row (27 columns; 39 under ``layout`` "pk"); ``moved``
    lanes whose tet changed load at least their new row."""
    _check(n, elem, "none", "whole", pending, moved)
    row_w = _widths(layout)[1]
    lane = (6 + 1 + row_w) * elem
    return Traffic(n + pending * lane + moved * row_w * elem, pending * lane,
                   pending * OPS["rare_lane"])


def convex_rare(n: int, elem: int, pending: int) -> Traffic:
    """``convex_rare_kernel``, a floor: ``pending`` lanes read pos, vel,
    tet and disp and their final cx row, and write pos, vel, tet and that
    row."""
    _check(n, elem, "none", "whole", pending)
    state = (6 + 1) * elem
    return Traffic(n + pending * (state + 3 * elem + CX_W * elem),
                   pending * (state + CX_W * elem), pending * OPS["rare_lane"])


# the two loads before a pending lane's walk: its flag and its own mega row
LANE_LOADS = 2


def latency_bound(chain_max: int, t_dep_ms: float, launch_floor_ms: float) -> float:
    """The least time of a rare kernel's call: one launch that does next
    to nothing (``launch_floor_ms``, measured on the card) plus the longest
    dependent chain, (2 + ``chain_max``) loads of ``t_dep_ms`` each: the
    flag, the lane's own mega row and ``chain_max`` row loads (the chain's
    counters, ``fused.rare_chain``).  Lanes run side by side, so only the
    longest chain counts; ``t_dep_ms`` is the neighbour walk's latency
    (``ops/probe.py``), the smaller of the two measured, so this stays a
    lower bound."""
    if chain_max < 0 or t_dep_ms < 0 or launch_floor_ms < 0:
        raise ValueError("chain length and times must be >= 0")
    return launch_floor_ms + (LANE_LOADS + chain_max) * t_dep_ms


def share_of_latency(latency_bound_ms: float, ms: float) -> float:
    """Share of its latency bound a rare kernel's call reaches:
    ``latency_bound_ms`` / ``ms``."""
    if ms <= 0 or latency_bound_ms < 0:
        raise ValueError("times must be positive")
    return latency_bound_ms / ms


# the AMG-CG kernels (csrc/amg.cu): a row plan is int32 offsets [n + 1], pos
# and col [nnz] (nnz = 2 nf, each face in its two rows); operations a term
# (a matvec's multiply and add; a level's neighbour smoothed as well) and a
# row (d x + acc, and a level's smoothing arithmetic)
AMG_OPS = {"term": 2, "row": 2, "level_term": 4, "level_row": 7}
INDEX = 4


def _plan_bytes(n: int, nnz: int) -> int:
    return INDEX * (n + 1 + 2 * nnz)


def _check_amg(elem, *sizes):
    if elem not in (4, 8):
        raise ValueError(f"element size must be 4 or 8, got {elem}")
    if any(s < 0 for s in sizes):
        raise ValueError(f"sizes {sizes} must be >= 0")


def amg_matvec(n: int, nf: int, elem: int, k: int = 1, sym: bool = False) -> Traffic:
    """``fv_matvec_kernel``: reads diag, x [n, k], upper and lower [nf]
    (one array when ``sym``) and the row plan (2 nf terms); writes y."""
    _check_amg(elem, n, nf)
    nnz = 2 * nf
    read = elem * (n + n * k + (1 if sym else 2) * nf) + _plan_bytes(n, nnz)
    return Traffic(read, elem * n * k, k * (AMG_OPS["term"] * nnz + AMG_OPS["row"] * n))


def amg_down(n: int, nc: int, nf: int, elem: int, rows_in: int | None = None) -> Traffic:
    """``amg_down_kernel`` on a level of n rows and nf faces: reads r,
    diag, off, the row plan and the restriction's plan (nc + 1 offsets,
    ``rows_in`` fine rows, default n); writes the coarse residual [nc]."""
    _check_amg(elem, n, nc, nf)
    rows_in = n if rows_in is None else rows_in
    read = elem * (2 * n + nf) + _plan_bytes(n, 2 * nf) + INDEX * (nc + 1 + rows_in)
    return Traffic(read, elem * nc,
                   AMG_OPS["level_term"] * 2 * nf + AMG_OPS["level_row"] * rows_in)


def amg_up(n: int, nc: int, nf: int, elem: int, valid: bool = False) -> Traffic:
    """``amg_up_kernel``: reads r, diag, off, the row plan, the
    prolongation index [n] (int32), xc [nc] and, on a shard, valid [n];
    writes x [n]."""
    _check_amg(elem, n, nc, nf)
    read = (elem * (2 * n + nf + nc + (n if valid else 0)) + _plan_bytes(n, 2 * nf)
            + INDEX * n)
    return Traffic(read, elem * n, AMG_OPS["level_term"] * 2 * nf + AMG_OPS["level_row"] * n)


def amg_coarsest(n: int, nf: int, elem: int, sweeps: int = 12) -> Traffic:
    """The coarsest level alone (``amg_tail_kernel`` on one level): reads
    r, diag, off and the row plan once, writes x; ``sweeps`` + 1 passes of
    arithmetic over the level."""
    _check_amg(elem, n, nf, sweeps)
    read = elem * (2 * n + nf) + _plan_bytes(n, 2 * nf)
    ops = sweeps * (AMG_OPS["term"] * 2 * nf + AMG_OPS["level_row"] * n) + 2 * n
    return Traffic(read, elem * n, ops)


def amg_tail(sizes, nfs, elem: int, valid: bool = False, sweeps: int = 12) -> Traffic:
    """``amg_tail_kernel`` on levels of ``sizes`` rows and ``nfs`` faces
    (the coarsest last): reads the top level's r, each level's diag, off
    and row plan, and above the coarsest its restriction's plan, its int32
    prolongation index and, on a shard, valid; writes the top level's x.
    Each level's arithmetic as :func:`amg_down` and :func:`amg_up`, the
    coarsest's as :func:`amg_coarsest`."""
    if len(sizes) != len(nfs) or not sizes:
        raise ValueError("one face count a level, at least one level")
    _check_amg(elem, *sizes, *nfs, sweeps)
    K = len(sizes)
    read, ops = elem * sizes[0], amg_coarsest(sizes[-1], nfs[-1], elem, sweeps).ops
    for k, (n, nf) in enumerate(zip(sizes, nfs)):
        read += elem * (n + nf) + _plan_bytes(n, 2 * nf)
        if k < K - 1:
            read += INDEX * (sizes[k + 1] + 1 + n) + INDEX * n + (elem * n if valid else 0)
            ops += 2 * (AMG_OPS["level_term"] * 2 * nf + AMG_OPS["level_row"] * n)
    return Traffic(read, elem * sizes[0], ops)


# the longest chain of dependent loads a row of a level kernel waits for,
# from the launch: the matvec's off -> pos/col -> coefficient and x; down's
# aoff -> acell -> off -> pos/col -> the neighbour's r and diag; up's off ->
# col -> agg -> xc
AMG_CHAIN = {"matvec": 3, "down": 5, "up": 4}


def amg_tail_chain(sizes, sweeps: int = 12, block0_rows: int | None = None) -> dict:
    """What ``amg_tail_kernel`` on levels of ``sizes`` rows (the coarsest
    last) must wait for, one after another: ``barriers``, cluster
    barriers; ``l2``, dependent loads from global memory; ``dsmem``, reads
    of another block's shared memory that wait on the phase before;
    ``smem``, a block's reads of its own shared memory that do.  Rows a
    thread takes in turn are independent and not counted.  A lower bound.

    ``block0_rows`` None: the earlier kernel (every level's phases over the
    cluster), kept as the yardstick of the same work: 2K - 2 barriers
    between its 2K - 1 phases (K - 1 down, the coarsest, K - 1 up); the
    top level's restriction chain from global
    memory (``AMG_CHAIN["down"]``, or the coarsest's r alone); after each
    barrier of the levels between the top and the coarsest one read of
    another block's shared memory (down: a neighbour's r; up: the coarse
    x); block 0's reads of the coarsest's r and of x in each sweep.  It
    assumes a phase's index and coefficient loads are issued before its
    barrier.

    ``block0_rows`` given: the tail plan's kernel (``ops/amg_tail.py``),
    whose prologue stages every phase's index data and coefficients, so
    they wait on nothing after it: C = the cluster levels; 2C barriers (C -
    1 restrictions, level P's residual into block 0, block 0's stretch, C -
    1 prolongations); two loads from global memory in the prologue (a plan
    word, then the value it indexes) and, over a cluster, the top's x' read
    back from global memory after the last barrier; one read of another
    block's shared memory after each cluster phase that reads a
    neighbour's s or x' there (restrictions 1 .. C - 2, level P's residual
    when P > 0, prolongations P .. 1); in block 0 one read of its own after
    each phase (level C's entry, each restriction and prolongation of its
    levels, each sweep)."""
    if not sizes or sweeps < 0:
        raise ValueError("at least one level and sweeps >= 0")
    K = len(sizes)
    if block0_rows is None:
        if K == 1:
            return dict(barriers=0, l2=1, dsmem=0, smem=sweeps)
        return dict(barriers=2 * K - 2, l2=AMG_CHAIN["down"], dsmem=(K - 2) + (K - 1),
                    smem=1 + sweeps)
    from .amg_tail import cluster_levels

    C = cluster_levels(sizes, block0_rows)
    if C == 0:
        return dict(barriers=0, l2=2, dsmem=0, smem=2 * (K - 1) + sweeps)
    return dict(barriers=2 * C, l2=3, dsmem=max(C - 2, 0) + (C >= 2) + (C - 1),
                smem=1 + 2 * (K - 1 - C) + sweeps)


def amg_latency_bound(launch_floor_ms: float, *terms) -> float:
    """The least time of a pressure-solve kernel that its launch and what it
    waits for bind: the launch floor plus each term's ``(count, unit_ms)``:
    dependent loads of ``t_dep`` (the neighbour walk's latency,
    ``ops/probe.py``), and for the tail its cluster barriers and shared
    memory reads (``probe.cluster_sync``, ``probe.smem_chase``)."""
    if launch_floor_ms < 0 or any(n < 0 or ms < 0 for n, ms in terms):
        raise ValueError("counts and times must be >= 0")
    return launch_floor_ms + sum(n * ms for n, ms in terms)
