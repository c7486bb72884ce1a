"""PyTorch port: ``ops/traffic.py``, the bytes each CUDA kernel must move
per call, pinned against hand counts at 10 lanes (float32, e = 4 bytes,
and float64, e = 8), and the bound derived from them."""

import torch_port_common  # noqa: F401  (caps torch at one thread)
import pytest

from cudaparticlesfoam_tpu_torch.ops import traffic

N = 10

# (kernel, kwargs, bytes read, bytes written), each counted by hand:
# mega row 32 columns, bary row 20, cx row 24, head 8, xi 3, disp 3
CASES = [
    # stream_kernel: mega + xi + hop rows | head + rows of lanes that hopped + pending byte
    ("stream", dict(elem=4, noise="xi", pass_="whole", hops=3, hopped=2),
     10 * 128 + 10 * 12 + 3 * 80, 10 * 32 + 2 * 80 + 10),
    ("stream", dict(elem=4, noise="philox", pass_="whole", hops=3, hopped=3), 1280 + 240,
     320 + 240 + 10),
    ("stream", dict(elem=4, noise="none", pass_="whole"), 1280, 330),
    ("stream", dict(elem=4, noise="xi", pass_="crossers"), 1280 + 120, 10),
    ("stream", dict(elem=4, noise="philox", pass_="admitted", hops=2, hopped=1),
     1280 + 160 + 10, 320 + 80 + 10),
    ("stream", dict(elem=8, noise="xi", pass_="whole", hops=3, hopped=2), 2560 + 240 + 480,
     640 + 320 + 10),
    ("stream", dict(elem=8, noise="philox", pass_="crossers"), 2560, 10),
    # convex_stream_kernel: mega + xi + cx rows loaded | head + hopped rows + disp + pending
    ("convex_stream", dict(elem=4, noise="xi", pass_="whole", row_loads=4, hopped=3),
     1280 + 120 + 4 * 96, 10 * 32 + 3 * 96 + 10 * 12 + 10),
    ("convex_stream", dict(elem=4, noise="philox", pass_="crossers"), 1280, 10),
    ("convex_stream", dict(elem=4, noise="none", pass_="admitted", row_loads=2, hopped=1),
     1280 + 192 + 10, 320 + 96 + 120 + 10),
    ("convex_stream", dict(elem=8, noise="philox", pass_="whole", row_loads=4, hopped=3),
     2560 + 4 * 192, 10 * 64 + 3 * 192 + 10 * 24 + 10),
    ("convex_stream", dict(elem=8, noise="xi", pass_="crossers"), 2560 + 240, 10),
    # macro_stream_kernel: phase + working rows + xi per sub-step + hop rows
    #                      | working heads + rows of lanes that hopped + their phase
    #                        + every pending byte
    ("macro_stream", dict(elem=4, noise="xi", pass_="whole", working=10, substeps=25, hops=3,
                          hopped=2), 10 + 1280 + 25 * 12 + 240, 320 + 160 + 10 + 10),
    ("macro_stream", dict(elem=4, noise="xi", pass_="crossers", working=4, substeps=6),
     10 + 512 + 72, 10),
    ("macro_stream", dict(elem=4, noise="philox", pass_="admitted", working=4, substeps=6,
                          hops=1, hopped=1), 10 + 512 + 80 + 10, 128 + 80 + 4 + 10),
    ("macro_stream", dict(elem=8, noise="philox", pass_="whole", working=10, substeps=25,
                          hops=3, hopped=3), 10 + 2560 + 480, 640 + 480 + 10 + 10),
    # the per-pass macro trips after the first (3 of 10 lanes working, 4 sub-steps between
    # them): phase + 3 rows + 4 xi triples | every flag byte; the apply pass also reads every
    # admission byte and 2 hop rows | 3 heads + 1 row + 3 phase bytes + every pending byte
    ("macro_stream", dict(elem=4, noise="xi", pass_="crossers", working=3, substeps=4),
     10 + 3 * 128 + 4 * 12, 10),
    ("macro_stream", dict(elem=4, noise="xi", pass_="admitted", working=3, substeps=4, hops=2,
                          hopped=1), 10 + 3 * 128 + 4 * 12 + 2 * 80 + 10, 3 * 32 + 80 + 3 + 10),
    # hop_admit: flags in, flags out, and its scratch (2 words + 1 per tile of 8192 lanes)
    ("hop_admit", dict(), 10 + 12, 10 + 12),
    # the rare kernels' floors
    ("rare", dict(elem=4, pending=2, moved=1), 10 + 2 * 108 + 80, 2 * 108),
    ("rare", dict(elem=8, pending=2, moved=1), 10 + 2 * 216 + 160, 2 * 216),
    ("convex_rare", dict(elem=4, pending=2), 10 + 2 * (28 + 12 + 96), 2 * (28 + 96)),
    ("convex_rare", dict(elem=8, pending=2), 10 + 2 * (56 + 24 + 192), 2 * (56 + 192)),
    # later macro trips: no lane working (flags only), float64 with Philox, one lane working
    ("macro_stream", dict(elem=4, noise="xi", pass_="crossers"), 10, 10),
    ("macro_stream", dict(elem=4, noise="xi", pass_="admitted"), 10 + 10, 10),
    ("macro_stream", dict(elem=8, noise="philox", pass_="crossers", working=3, substeps=4),
     10 + 3 * 256, 10),
    ("macro_stream", dict(elem=8, noise="philox", pass_="admitted", working=1, substeps=3,
                          hops=1, hopped=1), 10 + 256 + 160 + 10, 64 + 160 + 1 + 10),
    ("macro_stream", dict(elem=4, noise="none", pass_="whole", working=1, substeps=1),
     10 + 128, 32 + 1 + 10),
    # the VertexVelocity instantiations: mega row 40 columns, padded table row 32
    # stream: mega + xi + hop rows | head + rows of lanes that hopped + pending byte
    ("stream", dict(elem=4, noise="xi", hops=3, hopped=2, layout="pk"),
     10 * 160 + 10 * 12 + 3 * 128, 10 * 32 + 2 * 128 + 10),
    ("stream", dict(elem=4, noise="philox", hops=1, hopped=1, layout="pk"), 1600 + 128,
     320 + 128 + 10),
    ("stream", dict(elem=8, noise="xi", hops=4, hopped=3, layout="pk"),
     10 * 320 + 10 * 24 + 4 * 256, 10 * 64 + 3 * 256 + 10),
    ("stream", dict(elem=8, noise="none", layout="pk"), 3200, 640 + 10),
    # rare: flags + pending lanes' pos, vel, tet and 32-column row (39 columns) + new rows
    ("rare", dict(elem=4, pending=2, moved=1, layout="pk"), 10 + 2 * 156 + 128, 2 * 156),
    ("rare", dict(elem=8, pending=3, moved=2, layout="pk"), 10 + 3 * 312 + 2 * 256, 3 * 312),
    # the RK4 instantiations: the Euler pass's bytes plus one table row per stage-walk hop
    ("stream", dict(elem=4, noise="none", hops=2, hopped=2, rk4=True, stage_rows=5),
     1280 + 2 * 80 + 5 * 80, 320 + 2 * 80 + 10),
    ("stream", dict(elem=8, noise="xi", hops=1, hopped=1, layout="pk", rk4=True,
                    stage_rows=3),
     3200 + 240 + 256 + 3 * 256, 640 + 256 + 10),
    ("stream", dict(elem=4, noise="philox", rk4=True), 1280, 330),
    # the AMG-CG kernels at 10 rows, 12 faces: a row plan is 11 offsets and
    # 24 pos and 24 col entries (int32, 236 B)
    # fv_matvec: diag + x + upper + lower + plan | y
    ("amg_matvec", dict(nf=12, elem=4), 4 * (10 + 10 + 24) + 236, 40),
    ("amg_matvec", dict(nf=12, elem=8, k=3, sym=True), 8 * (10 + 30 + 12) + 236, 240),
    # down: r + diag + off + plan + restriction plan (6 offsets, 10 rows) | rc [5]
    ("amg_down", dict(nc=5, nf=12, elem=4), 4 * (20 + 12) + 236 + 4 * 16, 20),
    # up: r + diag + off + xc + valid + plan + the int32 prolongation index | x
    ("amg_up", dict(nc=5, nf=12, elem=8, valid=True), 8 * (20 + 12 + 5 + 10) + 236 + 40, 80),
    # coarsest: r + diag + off + plan | x (its sweeps re-read what it holds)
    ("amg_coarsest", dict(nf=12, elem=4), 4 * (20 + 12) + 236, 40),
]


@pytest.mark.parametrize("kernel, kw, read, written", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_bytes_match_a_hand_count(kernel, kw, read, written):
    t = getattr(traffic, kernel)(N, **kw)
    assert (t.read, t.written) == (read, written)
    assert t.bytes == read + written
    assert t.bound_ms == pytest.approx((read + written) / 3.35e12 * 1e3, rel=1e-12)
    assert t.bound_by == "bytes"


def test_slice_shape_admission_blocks():
    # 1M lanes: 123 tiles of 8192 lanes, 125 scratch words read and left zeroed
    t = traffic.hop_admit(1_000_000)
    assert (t.read, t.written) == (1_000_000 + 4 * 125, 1_000_000 + 4 * 125)
    assert t.ops == 250_000 * traffic.OPS["admit_group"]


@pytest.mark.parametrize("bound, floor, ms, share", [
    (0.0006, 0.002, 0.006, 0.002 / 0.006),      # a launch binds: hop_admit_kernel at 1M lanes
    (0.0008, 0.002, 0.014, 0.002 / 0.014),      # a rare kernel
    (0.0500, 0.002, 0.100, 0.5),                # bytes bind
    (0.0, 0.0, 1.0, 0.0),
])
def test_share_of_floor_takes_the_larger_floor(bound, floor, ms, share):
    assert traffic.share_of_floor(bound, floor, ms) == pytest.approx(share)


def test_share_of_floor_refuses_bad_times():
    for args in ((0.1, 0.1, 0.0), (-0.1, 0.1, 1.0), (0.1, -0.1, 1.0)):
        with pytest.raises(ValueError):
            traffic.share_of_floor(*args)


def test_bound_is_the_larger_of_bytes_and_operations():
    t = traffic.Traffic(read=1000, written=1000, ops=10**9)
    assert t.bytes_ms == pytest.approx(2000 / 3.35e12 * 1e3)
    assert t.ops_ms == pytest.approx(1e9 / 67e12 * 1e3)
    assert t.bound_ms == t.ops_ms and t.bound_by == "operations"
    both = traffic.stream(N, 4, "xi") + traffic.rare(N, 4, 1, 0)
    assert both.read == traffic.stream(N, 4, "xi").read + traffic.rare(N, 4, 1, 0).read


def test_operations_stay_far_below_bytes_at_the_slice():
    for t in (traffic.stream(1_000_000, 4, "philox", hops=130_000, hopped=120_000),
              traffic.stream(1_000_000, 4, "philox", hops=130_000, hopped=120_000, layout="pk"),
              traffic.convex_stream(1_000_000, 4, "philox", row_loads=130_000, hopped=120_000),
              traffic.macro_stream(1_000_000, 4, "philox", working=1_000_000,
                                   substeps=3_300_000, hops=410_000, hopped=380_000)):
        assert t.ops_ms < 0.25 * t.bytes_ms and t.bound_by == "bytes"


@pytest.mark.parametrize("call", [
    lambda: traffic.stream(N, 2, "xi"),
    lambda: traffic.stream(N, 4, "threefry"),
    lambda: traffic.stream(N, 4, "xi", pass_="apply"),
    lambda: traffic.stream(N, 4, "xi", pass_="crossers", hops=1),
    lambda: traffic.stream(N, 4, "xi", hops=1, hopped=2),
    lambda: traffic.convex_stream(N, 4, "xi", row_loads=2, hopped=3),
    lambda: traffic.convex_stream(N, 4, "xi", row_loads=N + 1, hopped=0),
    lambda: traffic.macro_stream(N, 4, "xi", working=2, substeps=17),
    lambda: traffic.macro_stream(N, 4, "xi", working=2, substeps=2, hops=3, hopped=3),
    lambda: traffic.rare(N, 4, pending=-1, moved=0),
    lambda: traffic.hop_admit(-1),
    lambda: traffic.macro_stream(N, 4, "xi", pass_="crossers", working=2, substeps=2, hops=1),
    lambda: traffic.stream(N, 4, "xi", layout="pk", pass_="crossers"),
    lambda: traffic.stream(N, 4, "xi", layout="pk", pass_="admitted"),
    lambda: traffic.stream(N, 4, "xi", layout="vertex"),
    lambda: traffic.rare(N, 4, pending=1, moved=0, layout="cx"),
    lambda: traffic.stream(N, 4, "xi", pass_="crossers", rk4=True, stage_rows=2),
    lambda: traffic.stream(N, 4, "xi", pass_="admitted", rk4=True),
    lambda: traffic.stream(N, 4, "none", rk4=True, stage_rows=-1),
    lambda: traffic.stream(N, 4, "none", stage_rows=2),
])
def test_bad_arguments_raise(call):
    with pytest.raises(ValueError):
        call()


# the rare kernels' latency bound: one launch + (flag + own mega row + the
# longest chain) dependent loads
@pytest.mark.parametrize("chain_max, t_dep, floor, bound", [
    (7, 0.0005, 0.0022, 0.0022 + 9 * 0.0005),
    (0, 0.0004, 0.0020, 0.0028),
    (50, 0.001, 0.0, 0.052),
    (3, 0.0, 0.0031, 0.0031),
])
def test_latency_bound_matches_a_hand_count(chain_max, t_dep, floor, bound):
    assert traffic.latency_bound(chain_max, t_dep, floor) == pytest.approx(bound, rel=1e-12)
    assert traffic.share_of_latency(bound, 2 * bound) == pytest.approx(0.5)


def test_share_of_latency_against_hand_values():
    assert traffic.share_of_latency(0.0067, 0.0134) == pytest.approx(0.5)
    assert traffic.share_of_latency(0.0067, 0.0067) == pytest.approx(1.0)
    assert traffic.share_of_latency(0.0, 0.02) == 0.0


@pytest.mark.parametrize("call", [
    lambda: traffic.latency_bound(-1, 0.0005, 0.002),
    lambda: traffic.latency_bound(3, -0.0005, 0.002),
    lambda: traffic.latency_bound(3, 0.0005, -0.002),
    lambda: traffic.share_of_latency(0.006, 0.0),
    lambda: traffic.share_of_latency(0.006, -1.0),
    lambda: traffic.share_of_latency(-0.006, 0.01),
])
def test_latency_bound_refuses_bad_arguments(call):
    with pytest.raises(ValueError):
        call()


def test_layout_widths_come_from_the_fused_layouts():
    from cudaparticlesfoam_tpu_torch.ops import fused

    assert traffic._widths("tet") == (fused.LAYOUT_TET.width, fused.LAYOUT_TET.tab_w) == (32, 20)
    assert traffic._widths("pk") == (fused.LAYOUT_PK.width, fused.LAYOUT_PK.tab_w) == (40, 32)
    assert traffic.LAYOUT_NAMES["pk"] is fused.LAYOUT_PK
    assert not hasattr(traffic, "LAYOUTS")


# the measuring chains of csrc/probe.cu, through their host loops
def test_chase_neighbours_host_loop_follows_the_hash():
    import torch

    from cudaparticlesfoam_tpu_torch.ops import probe

    # 3 tets in a row; faces 0..3 of tet t: t - 1, t + 1, a wall, t (itself)
    codes = [[-1, 1, -2, 0], [0, 2, -2, 1], [1, -3, -2, 2]]
    tab = torch.zeros((3, 20), dtype=torch.float32)
    tab[:, 15:19] = torch.tensor(codes, dtype=torch.float32)
    state = torch.tensor([1, 99], dtype=torch.int32)
    probe.chase_neighbours(tab, 15, 50, state)
    at, h = 1, 99
    for _ in range(50):
        h = (h * 1664525 + 1013904223) & 0xFFFFFFFF
        code = codes[at][h >> 30]
        at = code if code >= 0 else at
    assert int(state[0]) == at and int(state[1]) & 0xFFFFFFFF == h
    with pytest.raises(ValueError):
        probe.chase_neighbours(tab.double(), 15, 5, state)
    with pytest.raises(ValueError):
        probe.chase_neighbours(tab, 17, 5, state)


def test_permutation_is_one_cycle_through_every_entry():
    import torch

    from cudaparticlesfoam_tpu_torch.ops import probe

    nxt = probe.permutation(1000, 4, torch.device("cpu"))
    assert nxt.dtype == torch.int32 and sorted(nxt.tolist()) == list(range(1000))
    state = torch.zeros(2, dtype=torch.int32)
    seen = set()
    for _ in range(1000):
        probe.chase_permutation(nxt, 1, state)
        seen.add(int(state[0]))
    assert len(seen) == 1000 and int(state[0]) == 0
    with pytest.raises(ValueError):
        probe.chase_permutation(nxt.long(), 1, state)


def test_rk4_stream_adds_stage_rows_and_their_operations():
    """The RK4 stream's bytes are the Euler pass's plus 80 B (TET) or 128 B
    (PK) per stage-walk row in float32, and its operations grow with the
    three stages; at the north-star slice it stays bound by bytes."""
    for layout, row in (("tet", 80), ("pk", 128)):
        euler = traffic.stream(N, 4, "none", hops=3, hopped=2, layout=layout)
        rk4 = traffic.stream(N, 4, "none", hops=3, hopped=2, layout=layout, rk4=True,
                             stage_rows=7)
        assert rk4.read - euler.read == 7 * row and rk4.written == euler.written
        assert rk4.ops > euler.ops
        big = traffic.stream(1_000_000, 4, "none", hops=60_000, hopped=60_000, layout=layout,
                             rk4=True, stage_rows=150_000)
        assert big.bound_by == "bytes"


def test_amg_tail_reads_its_levels_and_writes_the_top():
    """The tail on levels of 10 and 5 rows (12 and 4 faces): the top's r,
    each level's diag, off and row plan (int32; the coarse one 6 offsets,
    8 + 8 entries), the restriction's plan and the prolongation index of
    the top (and valid on a shard); it writes the top's x.  A tail of one
    level is the coarsest alone."""
    t = traffic.amg_tail([10, 5], [12, 4], 4)
    plans = 4 * (11 + 48) + 4 * (6 + 16)
    assert t.read == 4 * 10 + 4 * (10 + 12 + 5 + 4) + plans + 4 * (5 + 1 + 10) + 4 * 10
    assert t.written == 40
    assert traffic.amg_tail([10, 5], [12, 4], 8, valid=True).read \
        == 8 * 10 + 8 * (31 + 10) + plans + 4 * (16 + 10)
    assert traffic.amg_tail([10], [12], 4) == traffic.amg_coarsest(10, 12, 4)
    with pytest.raises(ValueError):
        traffic.amg_tail([10, 5], [12], 4)


@pytest.mark.parametrize("sizes, want", [
    # the coarsest alone: its r from global memory, then x read back in each sweep
    ([116], dict(barriers=0, l2=1, dsmem=0, smem=12)),
    # one level above it: the top's restriction chain, the coarse x read up
    ([218, 116], dict(barriers=2, l2=5, dsmem=1, smem=13)),
    ([8192, 4096, 116], dict(barriers=4, l2=5, dsmem=3, smem=13)),
    # pitzDaily's tail (levels 1-7): 6 phases down, the coarsest, 6 up
    ([6_116, 3_077, 1_557, 802, 417, 218, 116], dict(barriers=12, l2=5, dsmem=11, smem=13)),
])
def test_amg_tail_chain(sizes, want):
    assert traffic.amg_tail_chain(sizes) == want


@pytest.mark.parametrize("sizes, want", [
    # all in block 0: no cluster barrier; the prologue's two loads
    ([116], dict(barriers=0, l2=2, dsmem=0, smem=12)),
    ([417, 218, 116], dict(barriers=0, l2=2, dsmem=0, smem=4 + 12)),
    # one cluster level: its residual into block 0, block 0's x' back
    ([802, 417, 218, 116], dict(barriers=2, l2=3, dsmem=0, smem=1 + 4 + 12)),
    # pitzDaily's tail (levels 1-7): 4 cluster levels, 8 barriers
    ([6_116, 3_077, 1_557, 802, 417, 218, 116], dict(barriers=8, l2=3, dsmem=6, smem=17)),
])
def test_amg_tail_chain_of_the_tail_plan(sizes, want):
    """The tail plan's kernel (block 0 from 512 rows): 2C barriers, the
    prologue's loads and the top's x' from global memory, a read of
    another block's shared memory after each cluster phase that reads a
    neighbour there, block 0's own reads; the earlier count stays the default."""
    assert traffic.amg_tail_chain(sizes, block0_rows=512) == want
    assert traffic.amg_tail_chain(sizes)["barriers"] == 2 * len(sizes) - 2


def test_amg_tail_chain_counts_sweeps_and_refuses_nothing():
    assert traffic.amg_tail_chain([116], sweeps=0)["smem"] == 0
    assert traffic.amg_tail_chain([218, 116], sweeps=3)["smem"] == 4
    with pytest.raises(ValueError):
        traffic.amg_tail_chain([])


def test_amg_latency_bound_adds_floor_chain_and_barriers():
    assert traffic.amg_latency_bound(2e-3, (5, 2e-4)) == pytest.approx(2e-3 + 5 * 2e-4)
    assert traffic.amg_latency_bound(2e-3, (5, 2e-4), (12, 7e-4), (11, 1e-4), (13, 2e-5)) \
        == pytest.approx(2e-3 + 5 * 2e-4 + 12 * 7e-4 + 11 * 1e-4 + 13 * 2e-5)
    assert traffic.amg_latency_bound(2e-3) == 2e-3
    with pytest.raises(ValueError):
        traffic.amg_latency_bound(2e-3, (-1, 2e-4))
    with pytest.raises(ValueError):
        traffic.amg_latency_bound(-1.0, (1, 2e-4))


def test_cluster_sync_counts_on_the_cpu_and_checks_its_state():
    import torch

    from cudaparticlesfoam_tpu_torch.ops import probe

    state = torch.zeros(16, dtype=torch.int32)
    probe.cluster_sync(7, 128, state)
    probe.cluster_sync(3, 512, state, mode="relaxed")
    assert state.tolist() == [10] * 16
    # a smaller cluster counts in its own blocks only; the tail's barrier
    probe.cluster_sync(2, 256, state, mode="one release", blocks=4)
    assert state.tolist() == [12] * 4 + [10] * 12
    for bad in (torch.zeros(8, dtype=torch.int32), torch.zeros(16, dtype=torch.int64)):
        with pytest.raises(ValueError):
            probe.cluster_sync(1, 128, bad)
    for kw in (dict(threads=1024), dict(mode="fence"), dict(blocks=17), dict(blocks=0)):
        with pytest.raises(ValueError):
            probe.cluster_sync(1, kw.pop("threads", 128), state, **kw)


def test_smem_chase_follows_its_cycle_on_the_cpu():
    """The plain version walks j -> (389 j + 1) mod 1024, a single cycle
    through all 1,024 slots, from state[0] mod 1024, and leaves where it
    stopped in state[0]."""
    import torch

    from cudaparticlesfoam_tpu_torch.ops import probe

    state = torch.tensor([5, 0], dtype=torch.int32)
    probe.smem_chase(3, state)
    assert int(state[0]) == (389 * ((389 * ((389 * 5 + 1) % 1024) + 1) % 1024) + 1) % 1024
    seen = set()
    state = torch.zeros(2, dtype=torch.int32)
    for _ in range(probe.CHASE_SLOTS):
        probe.smem_chase(1, state, remote=True)
        seen.add(int(state[0]))
    assert len(seen) == probe.CHASE_SLOTS and int(state[0]) == 0
    state = torch.tensor([1024 + 5, 0], dtype=torch.int32)     # a start is taken mod 1024
    probe.smem_chase(1, state)
    assert int(state[0]) == (389 * 5 + 1) % 1024
    with pytest.raises(ValueError):
        probe.smem_chase(-1, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        probe.smem_chase(1, torch.zeros(3, dtype=torch.int32))
