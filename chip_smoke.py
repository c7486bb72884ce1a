#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cudaparticlesfoam_tpu_torch) on one GPU.

    python3 chip_smoke.py               # the full check on cuda:0
    python3 chip_smoke.py --rehearse    # small sizes on the CPU, plain versions only
    python3 chip_smoke.py --parent DIR  # also phase 7 and 14a's tail, against the checkout in DIR
    python3 chip_smoke.py --phase amg-tail [--parent DIR]  # 14a alone (amg_system matrices)

Phases, one line of numbers each, any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc for sm_90a, one nvcc per source in
   parallel (seconds, and ptxas's registers/stack per kernel);
3. kernel vs plain, float32: box 16^3 (24,576 tets), 65,536 lanes and a
   ragged 65,499 (the last block of the staged stream kernels part full),
   one cycle, for hops {1, 4} x escape faces {off, on} x reflect_wall {on,
   off}: stream_kernel against stream_plain, then rare_kernel against
   rare_plain on the same (m, pending); tet/active/pending identical,
   pos/vel within 1e-5; the rare kernel also bit for bit on six pending
   patterns (the cycle's own, none, all, the last lane, the ragged tail
   group, the cycle's own in a view one byte off 16 B), one launch a call,
   in float32 and, after a float64 plain stream cycle, in float64;
3b. convex kernel vs plain, float32: the same box and both lane counts, one cycle, for
   inline_hops {0, 1} x escape faces {off, on} x (reflect_wall with
   convex_bary_fix | no reflection): convex_stream_kernel against
   convex_stream_plain, then convex_rare_kernel against convex_rare_plain
   on the same (m, disp, pending); same tolerances; the rare kernel on the
   six pending patterns, float32 and float64, as in phase 3;
3c. in-kernel Philox noise (brownian_rng "rbg_kernel"): one bary and one
   convex cycle through the kernels against the plain cycle fed
   philox_normals (tet/active identical, pos within 1e-5), then the kicks
   of 1,000,000 lanes without advection, divided by sigma: |mean| < 0.01,
   |variance - 1| < 0.003, through both stream kernels;
3d. the compacted hop gather (hop_compact=4).  First, before anything is
   timed, hop_admit_kernel against hop_admit_plain at 1, 3, 4, 15, 16, 17,
   65,499, 65,536, 1,000,000 and 4,000,001 lanes (no flag, every flag,
   random flags; capacity 0, a third of the groups, the groups, more), one
   scratch buffer for all of them, which must come back zeroed.  Then,
   float32, the same box and lanes, one cycle, bary and convex x frac {1.0,
   0.02} x escape faces {off, on}: the crossing-flag pass of each stream
   kernel against its plain version, hop_admit_kernel against
   hop_admit_plain, the apply pass against the plain apply (pending
   identical), and the state after the rare kernel against the uncompacted
   cycle's (identical);
3e. macro cycles (macro_cycles = k): the same box at 65,536 and 65,499
   lanes, one macro cycle, float32 for k {2, 4} x noise {xi, Philox} x
   escape faces {off, on} and float64 for k = 4 with escape faces: the
   kernels (macro_stream_kernel, hop_admit_kernel, rare_kernel) against the
   plain versions of the same trips (float64 within 1e-12), and against k
   per-cycle kernel cycles (identical, bit for bit); and for k = 4 with
   escape faces each pass of macro_stream_kernel (whole, crossers,
   admitted) against macro_stream_plain on phase vectors with random
   phases, with whole blocks finished, and with no lane working;
4. golden replay, float64, through the kernels: box_bary_adv,
   box_bary_brownian and box_convex_adv of tests/golden/particles_f64.npz
   from the recorded inputs in tests/golden/torch_port_box_inputs.npz;
   tet/active exact, pos within 1e-9;
5. the slice at the bench's north-star size: box 55^3 (998,250 tets) with
   the confined vortex, 1,000,000 owl-LCG seeds in [2.75, 52.25]^3,
   suggest_tuning(dt=0.05, D=1e-3); run_cycles 10 warm-up + 3 x 200 timed
   cycles (CUDA events), launch counts, domain checks, one extra cycle
   through kernel and plain, and each kernel's time against its plain
   version at this shape (stream_kernel with xi and with its Philox
   noise); then one 200-cycle run under "rbg_kernel";
5e. (runs after phase 5, before 5b) [pack]: pack_kernel and
   unpack_kernel (csrc/pack.cu, the per-call pack and unpack of
   run_cycles) against their plain versions (fused.pack_state and the
   clones of fused.unpack_state) on phase 3's box, float32 and float64,
   65,536 and 65,499 lanes, the three layouts (TET [n, 32] of 20-column
   rows, PK [n, 40] of the padded 32-column rows, convex [n, 32] of
   24-column rows), about one tet in eight negative, pos contiguous, a
   row-strided view and a column-strided copy: the mega, the five unpacked
   tensors and the mega packed again from its own head, bit for bit; then
   at phase 5's slice (1,000,000 lanes, float32) the same comparison on
   the state after 10 chained cycles and on that state four times over
   (4,000,000 lanes, the coupled driver's scale), and each kernel's device
   ms against its plain chain's (torch ops on the card), its bytes (each
   input read once, one table row per distinct tet; each output written
   once), its bound at 3.35 TB/s and the share bound / time, and the
   launches.  Phases 5b and 5d compare both kernels with their plain
   versions on the convex and VertexVelocity slices' states, and phase 5
   counts one pack and one unpack launch a run_cycles call;
5b. the convex slice (the bench's convex-default): the same mesh and
   seeds with locate_mode "convex" and brownian_rng "rbg_kernel", timed
   the same way, with the pending share, the domain checks, one extra
   cycle through kernel and plain, each convex kernel's time against its
   plain version (the stream kernel with xi and with Philox), and one
   200-cycle run under "threefry";
5c. the slice with macro_cycles=4: phase 5's mesh, seeds and tuning, 3 x
   200 cycles under threefry and one 200-cycle run under "rbg_kernel",
   launch counts, domain checks, peak memory and the host's time to enqueue
   each run, one macro cycle through kernels and plain versions, the times
   of macro_stream_kernel's trip 0 against its plain version, and for
   trips 1, 2 and 3, each on the state it really sees, the flag pass and
   the apply pass on their own with the trip's working lanes, sub-steps,
   crossers, admitted lanes and hops; hop_admit_kernel one call at a time,
   200 calls back to back, and 200 calls replayed from a CUDA graph (the
   device's time without the host's launch gap; a measuring device, not
   the port's path; the trips' passes are timed the same way).
   Then one 200-cycle run each of the bary slice and the convex-default
   with hop_compact=4, with the pending and overflow shares of one more
   cycle, the same checks, the compacted stream's time (flag pass +
   hop_admit + apply pass) against its plain version, and each pass alone.
3f. (runs after 3e) the VertexVelocity (Pk) instantiations of stream_kernel
   and rare_kernel against stream_plain and rare_plain under LAYOUT_PK: the
   same box with its radial vertex field, float32 and float64, 65,536 and
   65,499 lanes, inline_hops {1, 3} x escape faces {off, on} x noise {xi,
   Philox}; tet/active/pending and the row cache identical, pos/vel within
   1e-5 (float32) and 1e-12 (float64), the rare kernel bit for bit and on
   the six pending patterns, and the count of Pk launches;
5d. the slice under VertexVelocity: phase 5's mesh and seeds with the
   vortex evaluated at the vertices and with_pk_rows; 10 warm-up + 3 x 200
   timed cycles under threefry, launch counts of the Pk instantiations,
   domain checks, peak memory, the hop and pending shares of one extra
   cycle through kernel and plain, each Pk kernel's time against its plain
   version (stream with xi and with Philox), and one 200-cycle run under
   "rbg_kernel".  Then the simple engine (engine="simple", torch ops, no
   kernel) on the card: 65,536 lanes, float64, VertexVelocity, 5 cycles on
   an injected noise stream, equal to the cached engine (tet/active
   identical, pos/vel within 1e-12); and on the card run_cycles on a mesh
   without with_pk_rows raises instead of taking the simple engine.
6. bounds: for each kernel and pass timed at the slice's shape, the bytes
   its call must move (ops/traffic.py, from this run's counts of lanes that
   work, hop, cross or stay pending), its bound at 3.35 TB/s, the share
   bound / time, its launches per sub-step on its path, and the time of a
   device copy_ that moves as many bytes (half read, half written) as a
   yardstick of the bandwidth a plain stream achieves; the port never
   calls it.  For the kernels of a few megabytes (hop_admit_kernel and the
   two rare kernels) also the launch floor, the time of hop_admit_kernel on
   4 lanes replayed from a graph, the host's time to enqueue that launch
   through the wrapper, and the share of max(bound, floor).  Then the rare
   kernels' latency bound: chase_kernel (csrc/probe.cu, a measuring kernel
   the port never calls) gives the latency of one dependent load, along the
   neighbour codes of the slice's table and over a random chain as large;
   each rare kernel's pending lanes, their chains of row loads (rare_chain)
   and latency_bound = launch floor + (2 + longest chain) x that latency;
   its share bound / time (the device's time, replayed from a graph, as in
   the slice phases, which take these readings while their state is alive),
   its time with every pending lane moved first, and a sweep by longest
   chain;
7. (only with --parent DIR, a checkout of another commit) that tree's rare
   kernels, built from its sources, against this tree's on the slice's
   inputs, in turns, bit for bit, with both shares of the latency bound.
8. (runs after 5d, before phase 6, whose bounds and latency lines take
   8c's rows) the uncoupled driver, models/uncoupled.py, in a temporary
   copy of the repo's pitzDaily tutorial with the shear field of
   tests/test_golden.py's driver anchor at time 282:
   8a. the driver anchor: 200 particles, deltaT 0.01 (100 cycles), float64,
       uncoupled.run on the card with the JAX run's Brownian normals
       (tests/golden/torch_port_pitz_noise.npz) replayed through
       ops/fused.py:_brownian_noise; pos within 1e-9 of pitz_pos,
       tet/active exact, every launch count set to 0 before the run and
       exactly 100 stream and 100 rare launches after it; skipped with its
       reason where the base-point builder is not the anchor's (no g++);
   8b. the tutorial at its own settings (1e5 particles, dt 1e-4, deltaT
       0.1: 1000 cycles, saveInterval 10: 101 frames), float32, through
       ``python -m cudaparticlesfoam_tpu_torch uncoupled <case> --out <dir>``
       in a subprocess: every frame parses, in the last every lane active
       with a tet >= 0, inside the pitzDaily bounds, KEs all zeros, no lane
       out of the domain; the phase times (device spans and the host's),
       Advect ms/cycle, particle-steps/s, peak memory and the kernel
       launches the driver logs (one stream and one rare a cycle);
   8c. one cycle at 8b's shape (its mesh, seeds and tuning: inline_hops 1,
       inline_bounce on) after 100 cycles: stream_kernel and rare_kernel
       against their plain versions (tet/active/pending identical, pos/vel
       within 1e-5), the hop and pending shares, each kernel's time by
       graph replay and its plain version's; before it, the driver's
       run_cycles loop warm in process (in the driver's chunks and as one
       call: device and host ms/cycle) and one frame's copy and write.
   The rehearsal runs 8a as is and 8b/8c at 2,000 particles, deltaT 0.01.
9. (runs after 5d, before phase 8) RK4 on the cached engine and the duct
   oracle:
   9a. the RK4 instantiations of stream_kernel against stream_plain(rk4):
       float32 and float64 x TET and PK x inline_hops {1, 3} x escape faces
       {off, on} x noise {xi, Philox} x 65,536 and 65,499 lanes on the
       swirl box, the whole mega and the pending flags bit for bit, then
       rare_kernel after them bit for bit; every stage walks and some stage
       points leave the domain; one RK4 launch a case;
   9b. cached RK4 (the kernels) = simple RK4 (torch ops), float64, 65,536
       lanes, TetVelocity and VertexVelocity, 5 cycles on injected noise:
       tet/active identical, pos/vel within 1e-12;
   9c. the analytic square-duct oracle (tests/test_duct.py) through the
       kernels, float32 and float64, Euler and RK4: relative error max <
       0.02, median < 0.006, x/y untouched, every lane in the mesh;
   9d. the rk4-tracers cell (bench.py's rk4-tracers: RK4, wall rebound, no
       Brownian term) on phase 5's mesh and seeds, TetVelocity and
       VertexVelocity: 100 cycles with the counts set to 0 just before
       (one RK4 stream and one rare launch a cycle), ms/cycle,
       particle-steps/s, the host's issue time, peak memory, the domain
       checks, one more cycle kernel = plain with each stage's walkers and
       rows, stream_kernel<rk4>'s time against its plain version and
       rare_kernel's device time (their bounds in phase 6);
   9e. (with the build) ptxas's registers, stack and spills of the eight
       RK4 instantiations, and every other kernel's line against the lines
       pinned from the build before RK4 (where nvcc is the pinned one).
10. (runs after phase 8, before phase 6) the steady-flow solver
   (models/{fv,simple,turbulence,functions}.py: torch ops, no kernel) and
   the tutorial's Allrun on its field:
   10a. SIMPLE on the card against the port on the CPU, float64, from one
        state (the CPU's after 20 iterations; pitzDaily from its cold
        start), 10 iterations each: the channel of tests/test_flow.py with
        linearUpwind under Jacobi-CG (p_tol 1e-10) and AMG-CG, the 3-D duct
        with limitedLinear under both, the channel under kOmegaSST, and
        pitzDaily as it ships (kEpsilon, linearUpwind, AMG-CG): u, p, flux
        and the closure's fields within 1e-9 of each field's largest
        magnitude, the CG counts side by side (AMG-CG equal or within one,
        Jacobi-CG within 1%), the card run twice (bit for bit or not is
        printed); the 2-D channel under limitedLinear is printed, not
        checked (its V-limiter follows the empty direction's rounding);
   10b. tutorials/.../pitzDaily/Allrun through ``python -m
        cudaparticlesfoam_tpu_torch`` in subprocesses, float32, in a copy of
        the tutorial: blockmesh, dict deltaT 1.0, simple (cut to 100 of its
        500 iterations, which residualControl does not stop; written at
        282), dict deltaT 0.1, uncoupled at the tutorial's settings;
        simple's field finite, max |U| < 50, written inside [282, 382], U,
        p and phi read back, the streamline file parses; then phase 8b's
        frame checks, the mean x moved downstream,
        one stream and one rare launch a cycle; SIMPLE iterations, ms per
        iteration on the device and the host, CG iterations per solve,
        peak memory, and Advect ms/cycle beside 8b's on the shear field;
   10c. one SIMPLE iteration at 10b's state (its U and p, 5 iterations in
        process) split into momentum, pressure system, pressure solve
        (CG iterations x one, and one V-cycle alone), corrections and the
        kEpsilon step: device ms, the host's ms to issue, kernels and
        launch calls (torch.profiler) and the kernels' busy ms.
   The rehearsal runs 10a without pitzDaily, 10b with simple --iters 5
   and the tracker at 2,000 particles, deltaT 0.01, and 10c after one
   warm iteration.
11. (runs after phase 10, before phase 6, whose bounds and latency lines
   take 11c's rows) the coupled solver (models/{pimple,coupled,mrf,
   fvoptions,dynamicmesh,motionsolver}.py: torch ops, no kernel) and the
   TJunction through the kernels on a field that changes every step:
   11a. PIMPLE (FlowSolver.from_case + advance) on the card against the
        port on the CPU, float64, the card run twice: the shrunk TJunction
        of tests/test_coupled_e2e.py (kEpsilon, AMG-CG, the p0 ramps, 5
        steps at its adjustable dt), tests/test_mrf.py's spun box (one
        step) and tests/test_fvoptions.py's meanVelocityForce channel (5
        steps, grad_p too): fields within 1e-9, AMG-CG counts equal;
   11b. the dynamic mesh: refresh_geometry on the card = on the CPU = a
        rebuild from the moved points (float64, 1e-12, every row table) on
        a 16^3 cube moved by a solidBody rotation and by a velocityLaplacian
        step; stream_kernel and rare_kernel on the rotated float32 mesh
        against their plain versions at 65,536 and 65,499 lanes (phase 3's
        tolerances); tests/test_dynamicmesh.py's oscillating box through
        run_coupled, card against CPU, float64, the same replayed noise;
   11c. tutorials/.../TJunction/Allrun (blockmesh -> coupled) through the
        CLI in subprocesses at the tutorial's width (248,000 cells, 2.98M
        tets, 4e6 particles, dt 1e-4, float32, kEpsilon, probes,
        scalarTransport, the p0 ramps) with three cuts: --steps 3, the
        particle window opened at 0, saveInterval 20; per Eulerian step
        dt_e, cycles, flow ms (device, host), CG iterations per corrector,
        continuity, the velocity refresh's ms, Advect ms/cycle (device,
        issue), the frames' s; the init, launches (one stream and one rare
        a cycle), peak memory, every active lane in the domain, the phase
        within 240 s; then in process the state after step 1 and one
        cycle through stream_kernel and rare_kernel against their plain
        versions, with each kernel's time for phase 6; after 11d, steps 2
        and 3 in process with their Advect traced: each chunk of cycles'
        device and issue ms, and the device's kernels of each interval by
        name (torch.profiler), copies included;
   11d. one PIMPLE step on the TJunction at that state split into its
        stages (momentum predictor; each corrector's pressure system,
        pressure solve and correction; kEpsilon; Courant), as 10c splits
        a SIMPLE iteration; the whole step timed 5 times in each of two
        runs, its spread and the idle share at the fastest, median and
        slowest sample.
   The rehearsal runs 11a as is, 11b on a 6^3 cube at 3,072 lanes and 11c
   on the shrunk TJunction with 2,000 particles on the CPU.
12. (runs after phase 11, before phase 6, whose bounds and latency lines
   take its rows) the multi-device particle strategies (parallel/: one
   process, 4 shards on the visible card) and rare_kernel<T, L, kRemote>:
   12a. rare_kernel<remote> against rare_plain(remote=) on shard 1 of the
        16^3 box (the swirl field) partitioned into 4 slabs: TET and PK,
        float32 and float64, 65,536 and 65,499 lanes, the settle call
        (arrivals kicked about two cells from their tets' centroids) and the
        cycle call (after stream_kernel with bounce_on=False, esc_on=False),
        the six pending patterns of phase 3; bit for bit, one launch a call,
        lanes paused by the walk and after a bounce (both counted, > 0);
   12b. the north-star slice at full width (phase 5's mesh, seeds and
        tuning): ParticleEngine("dp", 4 shards) under threefry and under
        rbg_kernel, 10 warm-up + 3 x 200 timed cycles, launches, peak
        memory, the kernels' busy time (torch.profiler, 20 cycles) and the
        idle share, one shard's stream and rare kernels against their plain
        versions and timed; gate: threefry = the single-device run of the
        padded state, rbg_kernel = each shard's slice run with its lane
        offset, bit for bit, after 20 cycles.  Then the partitioned strategy
        through parallel/partition.py (distribute_particles with slack 1.25,
        MegaShards and make_partitioned_runner with cap_out_frac 0.125:
        bench.py's partitioned-1shard), S = 1 and S = 4, timed the same way
        with the host's issue time, launches per cycle by wrapper, migrated and
        deferred lanes per cycle; gates: every lane resident, in the domain,
        and after 20 cycles tet/active identical and pos within 1e-5 of the
        single-device run under brownian_rng="rbg"; rare_kernel<remote>'s
        time on a shard's real call; then the same at S = 4 under
        VertexVelocity for rare_kernel<pk, remote>;
   12c. uncoupled.run in process on the shipped pitzDaily (1e5 particles,
        1000 cycles, float64, useBrownianMotion 0, the shear field) single,
        dp and partitioned with 4 shards: tet/active identical, pos within
        1e-9; then ``uncoupled <case> --devices 4 --strategy partitioned
        --no-write`` through the CLI (float32): its engine line, launches,
        Advect ms/cycle and wall time.
   The rehearsal runs 12a at 1,024 lanes with two pending patterns, 12b on
   phase 5's rehearsal slice with 2 warm-up and 4-cycle gates, 12c at 200
   particles.
13. (runs after phase 11, on 11c's case, before phase 12) the
   domain-decomposed flow solve (parallel/{flowshard,graphpart}.py: torch
   ops, no kernel; 4 shards on the visible card in turn, cuda:0 x4):
   13a. [flowshard-parity], float64: the sharded PIMPLE step of
        tests/test_flowshard.py's cases (the duct in 4 and 8 slabs, upwind and
        linearUpwind, the (2,2,2) grid, the graph map on pitzDaily) on the
        card against the port's single-device step on the card (JAX's
        tolerances) and against itself on the CPU (1e-9, Jacobi-CG counts
        within 1%); ShardedFlowSolver on the shrunk TJunction (local AMG-CG,
        p_tol 1e-11) one step, card against CPU within 1e-9, AMG-CG counts
        equal, and a second solver's step on the card identical bit for bit;
   13b. [tj-par], the TJunction's Allrun-parallel at full width: ``coupled
        <case> --flow-devices 4 --no-write`` through the CLI on 11c's case
        with 11c's cuts (248,000 cells, 4e6 particles, kEpsilon, float32; 3
        steps, the window opened at 0) and a fourth, no frames (11c writes
        them at this width): per step flow ms, CG iterations per corrector,
        halo refreshes and MB, refresh and Advect ms, the launches (one
        stream and one rare a cycle), peak memory, every lane in the domain;
        then in process, on phase 11's loaded case, the single-device and the
        4-shard flow side by side for 3 steps (gates: U rel-max within 5e-4
        after step 1, U, p, k, epsilon, nut rel-RMS within 5e-3 after step
        3, the gathered flux's divergence below 1e-4), their ms and CG
        counts, decompose and build_local_amg seconds, a fourth sharded step
        profiled (its kernels, busy ms and span, so its idle share);
   13c. [tj-par-cycle]: one cycle of stream_kernel and rare_kernel on the
        particles after step 1's interval on the sharded field, against their
        plain versions (phase 11c's check), timed for phase 6;
   13d. [dryrun]: the port's dryrun_multichip(4) (DP, partitioned, sharded
        PIMPLE) on the card.
   Phase 13 within 240 s on the card.  The rehearsal runs 13a without
   pitzDaily and 13b on the shrunk TJunction with 2,000 particles.

14. the AMG-CG pressure solve's kernels (csrc/amg.cu: fv_matvec_kernel,
   amg_down_kernel, amg_up_kernel for the levels above the tail, and
   amg_tail_kernel, one thread-block cluster for the levels of at most
   amg_cuda.TAIL_ROWS rows and the coarsest) and the CG iteration replayed
   from a CUDA graph (fv._pcg), on 10c's pitzDaily state (after 10c), on two
   boxes (65,536 and 65,499 cells; after it), on 11d's TJunction state
   (after 11d) and on 13b's sharded solver (in 13b):
   14a. [amg-parity] each kernel against its plain version (ops/amg.py)
        bit for bit at every level of the hierarchy, float32 and float64:
        the matvec at level 0 (lower and upper apart) and on each coarse
        level, x [nc] and [nc, 3], down and up above the coarsest, the
        tail at every split (from the coarsest alone to the whole
        hierarchy; a split whose vectors do not fit in a block's shared
        memory, or one from at most TAIL_ROWS rows that cannot stage every
        level, must raise), on a TJunction shard's local hierarchy with
        valid, and on a 16 x 16 x 8 box with block 0 from 32 rows (up to
        six cluster levels); and the kernels' matvec against
        the op-by-op card path (torch.segment_reduce a row): rows differing,
        largest gap in ulps.
        [amg-times] each kernel's device ms (graph replays), its plain
        version's, bytes, bound and share (ops/traffic.py), each kernel's
        chain for its latency bound (priced in phase 6) and the tail's
        units: one cluster barrier (probe.cluster_sync) and one dependent
        read of a block's own and of another block's shared memory
        (probe.smem_chase); one cuSPARSE CSR torch.mv of the same matrix
        replayed from a graph beside the matvec; for the tail its plan
        (cluster levels, staged bytes a block, neighbours in another
        block), the earlier design's chain and this one's, its phases from block 0's
        clock (prologue, each level's down and up, the coarsest), the
        cluster barrier at 2, 4, 8 and 16 blocks (release in every thread,
        relaxed, warp 0 releasing), block 0 from 512 and 1024 rows and,
        with --parent, the parent's tail on the same inputs in turns; each
        level's down + up against the tail's two phases there (the
        crossover that fixes TAIL_ROWS);
   14b. [amg-graph] one pressure solve replayed from the graph = the eager
        loop bit for bit, the same CG count, one replay a CG iteration, the
        capture's ms, and a V-cycle's launches {amg_down: t, amg_up: t,
        amg_tail: 1};
   14c. [amg-modes] per V-cycle, CG iteration and SIMPLE iteration / PIMPLE
        step: ms, host ms, kernels and launch calls for the graph with the
        tail and with TAIL_ROWS = 0 (the level-by-level 2L + 1 launches) in turns, the
        kernels with the loop eager, and PR 13's op-by-op path;
        [amg-sharded] the same for 13b's 4-shard step (the tail, 2L + 1,
        op by op).
   The kernel table takes the four kernels on 10b's simple (launches from
   its CLI run) and on 11c's coupled run; each path must launch every one
   of them and replay the CG graph.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "particles_f64.npz")
INPUTS = os.path.join(HERE, "tests", "golden", "torch_port_box_inputs.npz")
POS_TOL_F32 = 1e-5       # kernel vs plain, float32 (both IEEE op for op)
POS_TOL_F64 = 1e-12      # kernel vs plain, float64
POS_TOL_GOLDEN = 1e-9    # float64 replay against the CPU-made anchors
RAGGED = 37              # phases 3/3b also run n - RAGGED lanes (a part-full last block)


class Failure(Exception):
    pass


def need(cond, what):
    if not cond:
        raise Failure(what)


def log(*a):
    print(*a, flush=True)


class Timer:
    """Milliseconds of the work between start() and stop(): CUDA events on
    the card, the host clock after a sync on the CPU (rehearsal)."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = self.torch.cuda.Event(enable_timing=True)
            self.t1 = self.torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.h0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.t1.record()
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1)
        return (time.perf_counter() - self.h0) * 1e3


def stream_args(cfg, dt, dtype, fused):
    dt_t, sigma = fused.scalars(cfg, dt, dtype)
    return dict(dt=dt_t, sigma=sigma, use_adv=cfg.use_advection,
                use_brown=cfg.use_brownian,
                bounce_on=cfg.reflect_wall and cfg.inline_bounce,
                esc_on=cfg.escape_faces, n_hops=cfg.inline_hops)


def rare_args(cfg):
    return dict(max_hops=cfg.max_hops, max_bounces=cfg.max_bounces,
                reflect_wall=cfg.reflect_wall)


def compare(torch, a, b, pa=None, pb=None):
    """(discrete state identical, max |d| over pos/vel) of two megas."""
    same = bool(torch.equal(a[:, 6], b[:, 6]) and torch.equal(a[:, 7], b[:, 7]))
    if pa is not None:
        same = same and bool(torch.equal(pa, pb))
    return same, float((a[:, :6] - b[:, :6]).abs().max())


def bitwise_equal(torch, a, b):
    """a and b hold the same bits (float32 / float64 tensors)."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and bool(torch.equal(a.view(it), b.view(it)))


# pending flags the rare kernels' frame (csrc/pending.cuh) must take: a
# cycle's own, none, every lane, one lane in the last (partial) strip, only
# the tail group past the last 16 B boundary, and the cycle's own flags in a
# view whose data pointer is one byte past a 16 B boundary
PATTERNS = ("real", "none", "all", "last", "tail", "unaligned")


def pend_pattern(torch, name, real):
    n = real.shape[0]
    if name == "real":
        return real
    if name == "none":
        return torch.zeros_like(real)
    if name == "all":
        return torch.ones_like(real)
    if name == "unaligned":
        buf = torch.zeros(n + 1, dtype=torch.uint8, device=real.device)
        view = buf[1:]
        view.copy_(real)
        if real.device.type == "cuda":
            need(view.data_ptr() % 16 != 0, "the unaligned pending view is aligned")
        return view
    p = torch.zeros_like(real)
    if name == "last":
        p[n - 1] = 1
    else:
        p[16 * ((n - 1) // 16):] = 1
    return p


def rare_patterns(torch, counter, kernel, plain, m, real, tag, patterns=PATTERNS):
    """The rare kernel ``kernel(m, pend)`` against ``plain(m, pend)`` on
    every pattern of ``patterns`` (default PATTERNS): the whole mega
    identical bit for bit, one launch a call.  Returns the launches made."""
    for name in patterns:
        pend = pend_pattern(torch, name, real)
        mk, mp = m.clone(), m.clone()
        before = counter.launches
        kernel(mk, pend)
        launched = counter.launches - before
        plain(mp, pend)
        need(bitwise_equal(torch, mk, mp), f"{tag} pending={name}: kernel != plain")
        if m.device.type == "cuda":
            need(launched == 1, f"{tag} pending={name}: {launched} launches for one call")
    return len(patterns)


def box_payload(tmesh, nside, dtype, vel_fn):
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    cen = pts[tets].mean(axis=1)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vel_fn(cen), vert_vel=vv,
                                     dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > nside - 1e-6).astype(np.int32)
    return payload


def vortex(nside):
    """The bench's confined vortex (bench.py:53-60): tangential speed
    ~ r (1 - (r/R)^2), zero at the walls."""
    def fn(cen):
        r = cen[:, :2] - nside / 2.0
        r2 = (r * r).sum(axis=1) / (nside / 2.0) ** 2
        omega = (5.2 / nside) * np.maximum(1.0 - r2, 0.0)
        u = np.zeros_like(cen)
        u[:, 0] = -r[:, 1] * omega
        u[:, 1] = r[:, 0] * omega
        return u
    return fn


def swirl(nside):
    """Outward plus a swirl: hops, walls and corner hits."""
    def fn(cen):
        c = cen - nside / 2.0
        return c / nside * 2.0 + np.stack([-c[:, 1], c[:, 0], 0 * c[:, 2]], 1) / nside
    return fn


def phase_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs):
    """Phase 3: each kernel against its plain version on the same inputs."""
    payload = box_payload(tmesh, nside, np.float32, swirl(nside))
    base = convert.to_mesh(payload, dev)
    rng = np.random.default_rng(3)
    pos = torch.as_tensor(rng.uniform(0.05, nside - 0.05, (n, 3)), dtype=torch.float32,
                          device=dev)
    tet = cpt.locate_seeds(base, cpt.build_grid_locator(base), pos)
    vel = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
    act = torch.as_tensor(rng.uniform(size=n) > 0.02, device=dev)
    xi = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
    for hops, esc, refl, nn in itertools.product((1, 4), (False, True), (True, False),
                                                 (n, n - RAGGED)):
        dt = 0.2 if hops == 1 else 0.9
        mesh = tmesh.set_boundary_escape(base, [1] if esc else [])
        m0 = fused.pack_state(fused.row_table(mesh), pos[:nn], vel[:nn], tet[:nn], act[:nn])
        cfg = cpt.StepConfig(dt=dt, diffusion_coeff=5e-3, inline_hops=hops,
                             escape_faces=esc, reflect_wall=refl)
        sa = stream_args(cfg, dt, torch.float32, fused)
        mk, mp = m0.clone(), m0.clone()
        pk = torch.empty(nn, dtype=torch.uint8, device=dev)
        pp = torch.empty_like(pk)
        fused_cuda.stream_cycle(mesh.tet_row, mk, xi[:nn], pk, **sa)
        fused.stream_plain(mesh.tet_row, mp, xi[:nn], pp, **sa)
        same_s, err_s = compare(torch, mk, mp, pk, pp)
        rk, rp = mp.clone(), mp.clone()
        fused_cuda.rare_resolve(mesh.tet_row, rk, pp, mesh.bd_escape, **rare_args(cfg))
        fused.rare_plain(mesh.tet_row, rp, pp, mesh.bd_escape, **rare_args(cfg))
        same_r, err_r = compare(torch, rk, rp)
        same_r = same_r and bitwise_equal(torch, rk, rp)
        npend = int(pp.sum())
        case = f"lanes={nn} hops={hops} esc={esc} refl={refl}"
        rare_patterns(
            torch, fused_cuda.rare_resolve,
            lambda mm, q: fused_cuda.rare_resolve(mesh.tet_row, mm, q, mesh.bd_escape,
                                                  **rare_args(cfg)),
            lambda mm, q: fused.rare_plain(mesh.tet_row, mm, q, mesh.bd_escape, **rare_args(cfg)),
            mp, pp, f"rare_kernel ({case})")
        log(f"[parity] lanes={nn} hops={hops} escape={int(esc)} reflect={int(refl)} "
            f"pending={npend} stream_identical={int(same_s)} "
            f"stream_max_abs_err={err_s:.3e} rare_identical={int(same_r)} "
            f"rare_max_abs_err={err_r:.3e} rare_patterns_identical=1 ({','.join(PATTERNS)})")
        need(npend > 0, f"parity case has no pending lanes ({case})")
        need(same_s and err_s <= POS_TOL_F32, f"stream_kernel != stream_plain ({case})")
        need(same_r and err_r <= POS_TOL_F32, f"rare_kernel != rare_plain ({case})")
        errs["stream"] = max(errs["stream"], err_s)
        errs["rare"] = max(errs["rare"], err_r)
    # rare_kernel<double> on the same pending patterns, after a float64
    # stream cycle of the plain version (escape faces, reflection)
    mesh = tmesh.set_boundary_escape(
        convert.to_mesh(box_payload(tmesh, nside, np.float64, swirl(nside)), dev), [1])
    cfg = cpt.StepConfig(dt=0.2, diffusion_coeff=5e-3, inline_hops=1, escape_faces=True,
                         reflect_wall=True)
    sa, ra = stream_args(cfg, cfg.dt, torch.float64, fused), rare_args(cfg)
    for nn in (n, n - RAGGED):
        m = fused.pack_state(fused.row_table(mesh), pos[:nn].double(), vel[:nn].double(),
                             tet[:nn], act[:nn])
        pp = torch.empty(nn, dtype=torch.uint8, device=dev)
        fused.stream_plain(mesh.tet_row, m, xi[:nn].double(), pp, **sa)
        need(int(pp.sum()) > 0, f"float64 parity case has no pending lanes (lanes={nn})")
        rare_patterns(
            torch, fused_cuda.rare_resolve,
            lambda mm, q: fused_cuda.rare_resolve(mesh.tet_row, mm, q, mesh.bd_escape, **ra),
            lambda mm, q: fused.rare_plain(mesh.tet_row, mm, q, mesh.bd_escape, **ra),
            m, pp, f"rare_kernel<double> (lanes={nn})")
        log(f"[parity] float64 lanes={nn} hops=1 escape=1 reflect=1 pending={int(pp.sum())} "
            f"rare_patterns_identical=1 ({','.join(PATTERNS)})")


def parity_lanes(torch, cpt, mesh, dev, nside, n, seed, dtype=None):
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0.05, nside - 0.05, (n, 3)), dtype=dtype, device=dev)
    tet = cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh), pos)
    vel = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev)
    act = torch.as_tensor(rng.uniform(size=n) > 0.02, device=dev)
    xi = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype, device=dev)
    return pos, vel, tet, act, xi


def phase_pk_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs):
    """Phase 3f: the VertexVelocity (Pk) instantiations of stream_kernel and
    rare_kernel against stream_plain and rare_plain under LAYOUT_PK."""
    ly = fused.LAYOUT_PK
    before = (fused_cuda.stream_cycle.launches, fused_cuda.rare_resolve.launches)
    cases = extra = 0
    for dtype, tol in ((torch.float32, POS_TOL_F32), (torch.float64, POS_TOL_F64)):
        npdt = np.float32 if dtype == torch.float32 else np.float64
        # the box's own radial vertex field drives lanes into every wall
        base = convert.to_mesh(box_payload(tmesh, nside, npdt, swirl(nside)), dev)
        pos, vel, tet, act, xi = parity_lanes(torch, cpt, base, dev, nside, n, seed=8,
                                              dtype=dtype)
        for hops, esc in itertools.product((1, 3), (False, True)):
            dt = 0.3 if hops == 1 else 0.9
            mesh = cpt.with_pk_rows(tmesh.set_boundary_escape(base, [1] if esc else []))
            tab = fused.row_table(mesh, ly)
            cfg = cpt.StepConfig(dt=dt, diffusion_coeff=5e-3, inline_hops=hops,
                                 escape_faces=esc, velocity_interp="VertexVelocity")
            sa = stream_args(cfg, dt, dtype, fused)
            for philox, nn in itertools.product((False, True), (n, n - RAGGED)):
                m0 = fused.pack_state(fused.row_table(mesh, ly), pos[:nn], vel[:nn], tet[:nn],
                                      act[:nn], ly.width)
                key = fused.philox_key(11, hops) if philox else None
                xi_p = fused.philox_normals(key, nn, dtype, dev) if philox else xi[:nn]
                mk, mp = m0.clone(), m0.clone()
                pk = torch.empty(nn, dtype=torch.uint8, device=dev)
                pp = torch.empty_like(pk)
                fused_cuda.stream_cycle(tab, mk, None if philox else xi[:nn], pk,
                                        noise_key=key, ly=ly, **sa)
                fused.stream_plain(tab, mp, xi_p, pp, ly=ly, **sa)
                same_s, err_s = compare(torch, mk, mp, pk, pp)
                same_s = same_s and bool(torch.equal(mk[:, 8:], mp[:, 8:]))   # the row cache
                rk, rp = mp.clone(), mp.clone()
                fused_cuda.rare_resolve(tab, rk, pp, mesh.bd_escape, ly=ly, **rare_args(cfg))
                fused.rare_plain(tab, rp, pp, mesh.bd_escape, ly=ly, **rare_args(cfg))
                same_r, err_r = compare(torch, rk, rp)
                same_r = same_r and bitwise_equal(torch, rk, rp)
                npend = int(pp.sum())
                absorbed = int(((mp[:, 7] == 0) & (m0[:, 7] == 1)).sum())
                cases += 1
                tname = str(dtype).replace("torch.", "")
                case = f"{tname} lanes={nn} hops={hops} esc={esc} philox={philox}"
                extra += rare_patterns(
                    torch, fused_cuda.rare_resolve,
                    lambda mm, q: fused_cuda.rare_resolve(tab, mm, q, mesh.bd_escape, ly=ly,
                                                          **rare_args(cfg)),
                    lambda mm, q: fused.rare_plain(tab, mm, q, mesh.bd_escape, ly=ly,
                                                   **rare_args(cfg)),
                    mp, pp, f"rare_kernel<pk> ({case})")
                log(f"[pk-parity] {tname} lanes={nn} hops={hops} escape={int(esc)} "
                    f"noise={'philox' if philox else 'xi'} pending={npend} absorbed={absorbed} "
                    f"stream_identical={int(same_s)} stream_max_abs_err={err_s:.3e} "
                    f"rare_identical={int(same_r)} rare_max_abs_err={err_r:.3e} "
                    f"rare_patterns_identical=1")
                need(npend > 0, f"pk parity case has no pending lanes ({case})")
                need(not esc or absorbed > 0, f"pk parity case absorbed no lane ({case})")
                need(same_s and err_s <= tol, f"stream_kernel<pk> != stream_plain ({case})")
                need(same_r and err_r <= tol, f"rare_kernel<pk> != rare_plain ({case})")
                if dtype == torch.float32:
                    errs["stream_pk"] = max(errs["stream_pk"], err_s)
                    errs["rare_pk"] = max(errs["rare_pk"], err_r)
    if dev.type == "cuda":
        got = (fused_cuda.stream_cycle.launches - before[0],
               fused_cuda.rare_resolve.launches - before[1])
        need(got == (cases, cases + extra),
             f"phase 3f launched the Pk kernels {got}, not {(cases, cases + extra)}")


def convex_stream_args(cfg, dt, dtype, fused):
    dt_t, sigma = fused.scalars(cfg, dt, dtype)
    return dict(dt=dt_t, sigma=sigma, use_adv=cfg.use_advection, use_brown=cfg.use_brownian,
                n_hops=cfg.inline_hops)


def convex_rare_args(cfg):
    return dict(max_hops=cfg.max_hops, reflect_wall=cfg.reflect_wall,
                bary_fix=cfg.convex_bary_fix, max_bounces=cfg.max_bounces)


def convex_cycle_pair(torch, fused_convex, fused_cuda, mesh, tab, m0, xi, key, xi_plain,
                      cfg, dt, fused):
    """One convex cycle through the kernels and through the plain versions
    on the same inputs: (stream identical, stream err, cycle identical,
    cycle err, pending count, kernel mega, plain mega, plain disp, plain
    pending)."""
    n, dev, T = m0.shape[0], m0.device, m0.dtype
    sa = convex_stream_args(cfg, dt, T, fused)
    mk, mp = m0.clone(), m0.clone()
    pk = torch.empty(n, dtype=torch.uint8, device=dev)
    pp = torch.empty_like(pk)
    dk = torch.empty((n, 3), dtype=T, device=dev)
    dp = torch.empty_like(dk)
    fused_cuda.convex_stream_cycle(tab, mk, xi, pk, dk, noise_key=key, **sa)
    fused_convex.convex_stream_plain(tab, mp, xi_plain, pp, dp, **sa)
    same_s, err_s = compare(torch, mk, mp, pk, pp)
    err_s = max(err_s, float((dk - dp).abs().max()) if n else 0.0)
    m1, d1, p1 = mp.clone(), dp.clone(), pp.clone()
    fused_cuda.convex_rare_resolve(mesh, tab, mk, dk, pk, **convex_rare_args(cfg))
    fused_convex.convex_rare_plain(mesh, tab, mp, dp, pp, **convex_rare_args(cfg))
    same_r, err_r = compare(torch, mk, mp)
    return same_s, err_s, same_r, err_r, int(p1.sum()), m1, d1, p1


def phase_convex_parity(torch, cpt, fused, fused_convex, fused_cuda, tmesh, convert, dev,
                        nside, n, errs):
    """Phase 3b: each convex kernel against its plain version."""
    payload = box_payload(tmesh, nside, np.float32, swirl(nside))
    base = convert.to_mesh(payload, dev)
    pos, vel, tet, act, xi = parity_lanes(torch, cpt, base, dev, nside, n, seed=4)
    for hops, esc in itertools.product((0, 1), (False, True)):
        mesh = cpt.with_convex_rows(tmesh.set_boundary_escape(base, [1] if esc else []))
        tab = fused_convex.cx_table(mesh)
        m0 = fused.pack_state(tab, pos, vel, tet, act, fused_convex.WIDTH)
        for refl, nn in itertools.product((True, False), (n, n - RAGGED)):
            cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3, inline_hops=hops,
                                 escape_faces=esc, reflect_wall=refl, convex_bary_fix=refl,
                                 locate_mode="convex")
            same_s, err_s, same_r, err_r, npend, m1, d1, p1 = convex_cycle_pair(
                torch, fused_convex, fused_cuda, mesh, tab, m0[:nn], xi[:nn], None, xi[:nn],
                cfg, cfg.dt, fused)
            case = f"lanes={nn} hops={hops} esc={esc} refl={refl}"
            ra = convex_rare_args(cfg)
            rare_patterns(
                torch, fused_cuda.convex_rare_resolve,
                lambda mm, q: fused_cuda.convex_rare_resolve(mesh, tab, mm, d1, q, **ra),
                lambda mm, q: fused_convex.convex_rare_plain(mesh, tab, mm, d1, q, **ra),
                m1, p1, f"convex_rare_kernel ({case})")
            log(f"[convex-parity] lanes={nn} hops={hops} escape={int(esc)} reflect={int(refl)} "
                f"bary_fix={int(refl)} pending={npend} stream_identical={int(same_s)} "
                f"stream_max_abs_err={err_s:.3e} rare_identical={int(same_r)} "
                f"rare_max_abs_err={err_r:.3e} rare_patterns_identical=1")
            need(npend > 0, f"convex parity case has no pending lanes ({case})")
            need(same_s and err_s <= POS_TOL_F32, f"convex_stream_kernel != plain ({case})")
            need(same_r and err_r <= POS_TOL_F32, f"convex_rare_kernel != plain ({case})")
            errs["convex_stream"] = max(errs["convex_stream"], err_s)
            errs["convex_rare"] = max(errs["convex_rare"], err_r)
    # convex_rare_kernel<double> on the same pending patterns, after a
    # float64 stream cycle of the plain version (escape faces, bary_fix)
    mesh = cpt.with_convex_rows(tmesh.set_boundary_escape(
        convert.to_mesh(box_payload(tmesh, nside, np.float64, swirl(nside)), dev), [1]))
    tab = fused_convex.cx_table(mesh)
    cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3, inline_hops=1, escape_faces=True,
                         reflect_wall=True, convex_bary_fix=True, locate_mode="convex")
    sa, ra = convex_stream_args(cfg, cfg.dt, torch.float64, fused), convex_rare_args(cfg)
    for nn in (n, n - RAGGED):
        m = fused.pack_state(tab, pos[:nn].double(), vel[:nn].double(), tet[:nn], act[:nn],
                             fused_convex.WIDTH)
        pp = torch.empty(nn, dtype=torch.uint8, device=dev)
        d = torch.empty((nn, 3), dtype=torch.float64, device=dev)
        fused_convex.convex_stream_plain(tab, m, xi[:nn].double(), pp, d, **sa)
        need(int(pp.sum()) > 0, f"float64 convex parity case has no pending lanes (lanes={nn})")
        rare_patterns(
            torch, fused_cuda.convex_rare_resolve,
            lambda mm, q: fused_cuda.convex_rare_resolve(mesh, tab, mm, d, q, **ra),
            lambda mm, q: fused_convex.convex_rare_plain(mesh, tab, mm, d, q, **ra),
            m, pp, f"convex_rare_kernel<double> (lanes={nn})")
        log(f"[convex-parity] float64 lanes={nn} hops=1 escape=1 reflect=1 bary_fix=1 "
            f"pending={int(pp.sum())} rare_patterns_identical=1")


def kick_stats(torch, z):
    z = z.double().reshape(-1)
    return float(z.mean().abs()), float(z.var() - 1.0)


def phase_noise(torch, cpt, fused, fused_convex, fused_cuda, tmesh, convert, dev, nside, n,
                n_stats, errs):
    """Phase 3c: the in-kernel Philox stream against the plain one."""
    payload = box_payload(tmesh, nside, np.float32, swirl(nside))
    mesh = cpt.with_convex_rows(convert.to_mesh(payload, dev))
    pos, vel, tet, act, _ = parity_lanes(torch, cpt, mesh, dev, nside, n, seed=5)
    seed, step = 2024, 17
    key = fused.philox_key(seed, step)
    xi = fused.philox_normals(key, n, torch.float32, dev)
    cfg = cpt.StepConfig(dt=0.2, diffusion_coeff=5e-3, brownian_rng="rbg_kernel")
    # bary: the kernel cycle (mega_cycle draws in the kernel) vs plain
    m0 = fused.pack_state(fused.row_table(mesh), pos, vel, tet, act)
    mk = fused.mega_cycle(mesh, m0.clone(), seed, step, cfg, cfg.dt)
    mp, pp = m0.clone(), torch.empty(n, dtype=torch.uint8, device=dev)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **stream_args(cfg, cfg.dt, mp.dtype, fused))
    fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **rare_args(cfg))
    same_b, err_b = compare(torch, mk, mp)
    # convex, the same way
    ccfg = dataclasses.replace(cfg, locate_mode="convex")
    tab = fused_convex.cx_table(mesh)
    c0 = fused.pack_state(tab, pos, vel, tet, act, fused_convex.WIDTH)
    ck = fused_convex.mega_cycle(mesh, tab, c0.clone(), seed, step, ccfg, ccfg.dt)
    cp = c0.clone()
    dp = torch.empty((n, 3), dtype=torch.float32, device=dev)
    fused_convex.convex_stream_plain(tab, cp, xi, pp, dp,
                                     **convex_stream_args(ccfg, ccfg.dt, cp.dtype, fused))
    fused_convex.convex_rare_plain(mesh, tab, cp, dp, pp, **convex_rare_args(ccfg))
    same_c, err_c = compare(torch, ck, cp)
    log(f"[noise] rbg_kernel cycle vs plain+philox_normals, {n} lanes: "
        f"bary_identical={int(same_b)} bary_max_abs_err={err_b:.3e} "
        f"convex_identical={int(same_c)} convex_max_abs_err={err_c:.3e}")
    need(same_b and err_b <= POS_TOL_F32, "bary rbg_kernel cycle != plain")
    need(same_c and err_c <= POS_TOL_F32, "convex rbg_kernel cycle != plain")
    errs["stream"] = max(errs["stream"], err_b)
    errs["convex_stream"] = max(errs["convex_stream"], err_c)

    # statistics of the kicks, no advection: convex disp / sigma, and the
    # bary kernel's move / sigma (no hops, no bounce, nothing pending)
    rng = np.random.default_rng(6)
    p = torch.as_tensor(rng.uniform(1.0, nside - 1.0, (n_stats, 3)), dtype=torch.float32,
                        device=dev)
    t = torch.zeros(n_stats, dtype=torch.int32, device=dev)
    on = torch.ones(n_stats, dtype=torch.bool, device=dev)
    scfg = cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3, use_advection=False)
    dt_t, sigma = fused.scalars(scfg, scfg.dt, torch.float32)
    cm = fused.pack_state(tab, p, torch.zeros_like(p), t, on, fused_convex.WIDTH)
    pend = torch.empty(n_stats, dtype=torch.uint8, device=dev)
    disp = torch.empty((n_stats, 3), dtype=torch.float32, device=dev)
    fused_cuda.convex_stream_cycle(tab, cm, None, pend, disp, dt=dt_t, sigma=sigma,
                                   use_adv=False, use_brown=True, n_hops=0,
                                   noise_key=fused.philox_key(7, 3))
    bm = fused.pack_state(fused.row_table(mesh), p, torch.zeros_like(p), t, on)
    fused_cuda.stream_cycle(mesh.tet_row, bm, None, pend, dt=dt_t, sigma=sigma,
                            use_adv=False, use_brown=True, bounce_on=False, esc_on=False,
                            n_hops=0, noise_key=fused.philox_key(7, 4))
    for name, z in (("convex", disp / sigma), ("bary", (bm[:, :3] - p) / sigma)):
        mean_abs, var_dev = kick_stats(torch, z)
        log(f"[noise] {name} kick/sigma over {n_stats} lanes x 3: |mean|={mean_abs:.3e} "
            f"variance-1={var_dev:+.3e}")
        need(mean_abs < 0.01 and abs(var_dev) < 0.003, f"{name} in-kernel noise statistics")


def phase_golden(torch, cpt, convert, fused_cuda, dev):
    """Phase 4: replay the f64 golden box anchors through the kernels."""
    g = np.load(GOLDEN)
    fx = np.load(INPUTS)
    mesh = cpt.replace_velocity(cpt.box_mesh(6, 6, 6, dtype=np.float64, device=dev),
                                tet_vel=fx["tet_vel"])
    st = convert.to_state(fx["seed_pos"], fx["seed_tet"], dtype=np.float64, device=dev)
    mesh_cx = cpt.with_convex_rows(mesh)
    for name, kw, noise in (
        ("bary_adv", dict(use_brownian=False), None),
        ("bary_brownian", dict(diffusion_coeff=1e-3),
         torch.as_tensor(fx["noise"], device=dev)),
        ("convex_adv", dict(use_brownian=False, locate_mode="convex"), None),
    ):
        counters = ((fused_cuda.convex_stream_cycle, fused_cuda.convex_rare_resolve)
                    if "locate_mode" in kw else
                    (fused_cuda.stream_cycle, fused_cuda.rare_resolve))
        before = tuple(c.launches for c in counters)
        fin = cpt.run_cycles(mesh_cx, st, cpt.StepConfig(dt=0.08, **kw), 60, noise=noise)
        err = float(np.abs(fin.pos.cpu().numpy() - g[f"box_{name}_pos"]).max())
        tet_ok = bool((fin.tet_id.cpu().numpy() == g[f"box_{name}_tet"]).all())
        act_ok = bool((fin.active.cpu().numpy() == g[f"box_{name}_active"]).all())
        launched = tuple(c.launches - b for c, b in zip(counters, before))
        log(f"[golden] {name} f64 max_abs_err={err:.3e} tet_exact={int(tet_ok)} "
            f"active_exact={int(act_ok)} launches={launched}")
        need(tet_ok and act_ok and err <= POS_TOL_GOLDEN, f"golden replay {name} failed")
        if dev.type == "cuda":
            need(launched == (60, 60), f"golden replay {name} did not run the kernels")


def time_calls(timer, fn, restore, reps):
    """Mean ms of fn() over reps, each after restore() (outside the timing)."""
    total = 0.0
    for _ in range(reps):
        restore()
        timer.start()
        fn()
        total += timer.stop()
    return total / reps


def moved(torch, before, after):
    """Lanes whose tet changed from mega ``before`` to ``after`` and is a
    tet (not an exit code): each loaded that tet's row once."""
    t0, t1 = before[:, 6], after[:, 6]
    return int(((t0 != t1) & (t1 >= 0)).sum())


def rows_changed(torch, before, after, width):
    """Lanes whose cached row (mega columns 8 : 8 + width) changed from
    ``before`` to ``after``: each loaded a new row and wrote it back (a
    lane that hopped twice counts once, so as row loads this is a floor)."""
    return int((before[:, 8:8 + width] != after[:, 8:8 + width]).any(dim=1).sum())


@dataclasses.dataclass
class RareCase:
    """One rare kernel's call at the slice, for phase 6 (the latency bound
    and the pending-first run) and the parent A/B: the inputs (the state
    after the stream kernel, its pending flags, and disp for the convex
    kernel), each pending lane's chain (``rare_chain``), the wrapper's call
    ``run(m, pend, disp)`` and the bare C call ``c_call(fn, m, pend, disp,
    stream)`` of the kernel's entry ``entry`` in any build of the library.
    A case whose entry is None (the remote instantiations, which an earlier
    build lacks) takes no A/B."""
    m1: object
    p1: object
    d1: object
    chain: object
    run: object
    c_call: object
    entry: str


class RareStudy:
    """The readings of phases 6 and 7 that need a rare case's inputs,
    taken by ``add`` in phases 5, 5b and 5d while those are alive: the
    chain statistics, the call on the real and on the pending-first order,
    the chain sweep and, with ``parent`` (the other build's library and
    this one's), the A/B.  Only numbers are kept, so no later phase holds
    a slice's state and its peak memory stays the port's."""

    def __init__(self, torch, dev, parent=None):
        self.torch, self.dev, self.parent, self.rows = torch, dev, parent, {}

    def add(self, name, case):
        torch = self.torch
        timer = Timer(torch, self.dev)
        mean, p99, cmax = chain_stats(torch, case.chain)
        real_ms, w_real = rare_call_ms(torch, timer, case.run, case.m1, case.p1, case.d1)
        m_f, p_f, d_f, order = pending_first(torch, case)
        first_ms, w_first = rare_call_ms(torch, timer, case.run, m_f, p_f, d_f)
        need(bitwise_equal(torch, w_first, w_real[order]),
             f"{name}: the pending-first run differs from the real one")
        del w_real, w_first, m_f, p_f, d_f
        sweep, per_step, at_zero = chain_sweep(torch, timer, case)
        self.rows[name] = dict(
            lanes=case.m1.shape[0], pending=int(case.p1.sum()), chain_mean=mean, chain_p99=p99,
            chain_max=cmax, real_ms=real_ms, pending_first_ms=first_ms, sweep=sweep,
            ms_per_chain_step=per_step, ms_at_chain_0=at_zero,
            parent=parent_ab(torch, timer, self.dev, name, case, *self.parent)
            if self.parent and case.entry else None)


def rare_row(torch, timer, fn, plain, restore):
    """(device ms, plain ms, (plain, one call at a time, one call at a
    time, plain)) of a rare kernel: the device's time by device_ms with
    ``restore`` (graph replay, the restore copy subtracted); one call at a
    time reads the host's launch cost as much as the kernel, and stays
    beside it so that the earlier readings can be compared."""
    _, p_ms, parts = kernel_vs_plain_ms(timer, fn, plain, restore)
    return device_ms(torch, timer, fn, restore), p_ms, parts


def bary_rare_case(torch, fused, fused_cuda, tab, mesh, m1, p1, ra, ly, entry):
    return RareCase(
        m1, p1, None, fused.rare_chain(tab, m1, p1, mesh.bd_escape, ly=ly, **ra),
        lambda m, p, d: fused_cuda.rare_resolve(tab, m, p, mesh.bd_escape, ly=ly, **ra),
        lambda f, m, p, d, s: f(tab.data_ptr(), m.data_ptr(), p.data_ptr(),
                                mesh.bd_escape.data_ptr(), m.shape[0],
                                mesh.bd_escape.shape[0], ra["max_hops"], ra["max_bounces"],
                                int(ra["reflect_wall"]), s),
        entry)


def phase_slice(torch, cpt, fused, fused_cuda, tmesh, dev, nside, n_particles,
                n_cycles, errs, counts, rares, gpu_line):
    """Phase 5: the north-star slice through run_cycles."""
    t0 = time.perf_counter()
    pts, tets, _ = tmesh.box_points_tets(nside, nside, nside)
    mesh = cpt.box_mesh(nside, nside, nside, device=dev)
    mesh = cpt.replace_velocity(mesh, tet_vel=vortex(nside)(pts[tets].mean(axis=1)))
    t_mesh = time.perf_counter() - t0
    lo, hi = 0.05 * nside, 0.95 * nside
    st = cpt.seed_in_box(n_particles, (lo,) * 3, (hi,) * 3, device=dev)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(
        mesh, cpt.build_grid_locator(mesh), st.pos))
    n_in = int((st.tet_id >= 0).sum())
    cfg = cpt.suggest_tuning(mesh, cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3),
                             n_particles=n_particles)
    t_setup = time.perf_counter() - t0
    log(f"[slice] tets={mesh.n_tets} particles={n_particles} seeds_in_domain={n_in} "
        f"inline_hops={cfg.inline_hops} inline_bounce={int(cfg.inline_bounce)} "
        f"mesh_build_s={t_mesh:.2f} setup_s={t_setup:.2f}")

    st0 = st
    st = cpt.run_cycles(mesh, st, cfg, 10)            # warm-up
    timer = Timer(torch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for w in (fused_cuda.stream_cycle, fused_cuda.rare_resolve, fused_cuda.pack_rows,
              fused_cuda.unpack_rows):
        w.launches = 0
    runs = []
    for _ in range(3):
        timer.start()
        st = cpt.run_cycles(mesh, st, cfg, n_cycles)
        runs.append(timer.stop())
    launches = {"stream": fused_cuda.stream_cycle.launches,
                "rare": fused_cuda.rare_resolve.launches,
                "pack": fused_cuda.pack_rows.launches, "unpack": fused_cuda.unpack_rows.launches}
    ms_cycle = [r / n_cycles for r in runs]
    med = float(np.median(ms_cycle))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[slice] {gpu_line} | ms_per_cycle={['%.4f' % x for x in ms_cycle]} "
        f"median={med:.4f} particle_steps_per_s={n_particles / (med * 1e-3):.4e} "
        f"max_memory_allocated={peak} launches={launches}")
    if dev.type == "cuda":
        need(launches == {"stream": 3 * n_cycles, "rare": 3 * n_cycles, "pack": 3, "unpack": 3},
             f"launch counts {launches} != {3 * n_cycles} per cycle kernel and 3 per pack "
             f"kernel")

    d = cpt.diagnostics(st)
    active = int(d["active"])
    bad = int((st.active & (st.tet_id < 0)).sum())
    blo, bhi = mesh.bounds_lo.to(st.dtype), mesh.bounds_hi.to(st.dtype)
    outside = int(((st.pos < blo - 1e-3) | (st.pos > bhi + 1e-3)).any(dim=1).sum())
    log(f"[slice] active={active} seeds_in_domain={n_in} active_with_negative_tet={bad} "
        f"outside_bounds={outside} kinetic_energy={float(d['kinetic_energy']):.6e}")
    need(active == n_in and bad == 0 and outside == 0, "slice left the domain")
    need(bool(torch.isfinite(st.pos).all()), "non-finite positions")

    # one extra cycle through kernel and plain on the same inputs, and each
    # kernel's time against its plain version at this shape
    m0 = fused.pack_state(fused.row_table(mesh), st.pos, st.vel, st.tet_id, st.active)
    xi = fused._brownian_noise(st.seed, st.step, n_particles, m0.dtype, dev)
    sa = stream_args(cfg, cfg.dt, m0.dtype, fused)
    mk, mp = m0.clone(), m0.clone()
    pk = torch.empty(n_particles, dtype=torch.uint8, device=dev)
    pp = torch.empty_like(pk)
    fused_cuda.stream_cycle(mesh.tet_row, mk, xi, pk, **sa)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **sa)
    same_s, err_s = compare(torch, mk, mp, pk, pp)
    m1, p1 = mp.clone(), pp.clone()
    n_el = m0.element_size()
    # one inline hop at this slice, so row loads = lanes whose row changed
    hk = rows_changed(torch, m0, mk, 20)
    counts["stream"] = ("stream", dict(n=n_particles, elem=n_el, noise="xi", hops=hk,
                                       hopped=hk))
    nkey = fused.philox_key(st.seed, st.step)
    mph, pph = m0.clone(), torch.empty_like(pk)
    fused_cuda.stream_cycle(mesh.tet_row, mph, None, pph, noise_key=nkey, **sa)
    hph = rows_changed(torch, m0, mph, 20)
    counts["stream_philox"] = ("stream", dict(n=n_particles, elem=n_el, noise="philox",
                                              hops=hph, hopped=hph))
    fused_cuda.rare_resolve(mesh.tet_row, mk, pk, mesh.bd_escape, **rare_args(cfg))
    counts["rare"] = ("rare", dict(n=n_particles, elem=n_el, pending=int(p1.sum()),
                                   moved=moved(torch, m1, mk)))
    fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **rare_args(cfg))
    same, err = compare(torch, mk, mp)
    log(f"[slice] extra cycle kernel vs plain: pending={int(p1.sum())} "
        f"stream_identical={int(same_s)} stream_max_abs_err={err_s:.3e} "
        f"cycle_identical={int(same)} cycle_max_abs_err={err:.3e}")
    need(same_s and same and max(err, err_s) <= POS_TOL_F32, "extra cycle kernel != plain")
    errs["stream"] = max(errs["stream"], err_s)
    errs["rare"] = max(errs["rare"], err)

    work, pend = m0.clone(), pk.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)

    times = {}
    ra = rare_args(cfg)
    times["rare"] = rare_row(
        torch, timer, lambda: fused_cuda.rare_resolve(mesh.tet_row, work, pend, mesh.bd_escape,
                                                      **ra),
        lambda: fused.rare_plain(mesh.tet_row, work, pend, mesh.bd_escape, **ra), restore_rare)
    rares.add("rare", bary_rare_case(torch, fused, fused_cuda, mesh.tet_row, mesh, m1, p1, ra,
                                     fused.LAYOUT_TET, "cpf_rare_f32"))
    t = times["rare"]
    log(f"[slice] {gpu_line} | rare_kernel_ms={t[0]:.5f} (device: {BATCH} calls replayed from a "
        f"graph, restore subtracted) one_call_at_a_time_ms=({t[2][1]:.4f}, {t[2][2]:.4f}) "
        f"rare_plain_ms={t[1]:.4f} ({t[2][0]:.4f}, {t[2][3]:.4f}) lanes={n_particles}")
    for key, fn, plain, restore in (
        ("stream", lambda: fused_cuda.stream_cycle(mesh.tet_row, work, xi, pend, **sa),
         lambda: fused.stream_plain(mesh.tet_row, work, xi, pend, **sa), restore_stream),
        ("stream_philox",
         lambda: fused_cuda.stream_cycle(mesh.tet_row, work, None, pend, noise_key=nkey, **sa),
         lambda: fused.stream_plain(mesh.tet_row, work,
                                    fused.philox_normals(nkey, n_particles, work.dtype, dev),
                                    pend, **sa), restore_stream),
    ):
        fn(), plain()    # warm-up
        # alternate plain, kernel, kernel, plain
        p_a = time_calls(timer, plain, restore, 5)
        k_a = time_calls(timer, fn, restore, 20)
        k_b = time_calls(timer, fn, restore, 20)
        p_b = time_calls(timer, plain, restore, 5)
        times[key] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
        log(f"[slice] {gpu_line} | {key}_kernel_ms={times[key][0]:.4f} "
            f"({k_a:.4f}, {k_b:.4f}) {key}_plain_ms={times[key][1]:.4f} "
            f"({p_a:.4f}, {p_b:.4f}) lanes={n_particles}")

    # the same slice with the noise drawn inside the stream kernel
    rcfg = dataclasses.replace(cfg, brownian_rng="rbg_kernel")
    st_r = cpt.run_cycles(mesh, st, rcfg, 10)         # warm-up
    timer.start()
    st_r = cpt.run_cycles(mesh, st_r, rcfg, n_cycles)
    ms_r = timer.stop() / n_cycles
    bad_r = int((st_r.active & (st_r.tet_id < 0)).sum())
    log(f"[slice] {gpu_line} | brownian_rng=rbg_kernel ms_per_cycle={ms_r:.4f} "
        f"particle_steps_per_s={n_particles / (ms_r * 1e-3):.4e} (threefry median "
        f"{med:.4f}) active_with_negative_tet={bad_r}")
    need(bad_r == 0 and bool(torch.isfinite(st_r.pos).all()), "rbg_kernel slice left the domain")
    return launches, times, med, (mesh, st0, n_in, cfg)


PACK_LAYOUTS = ("tet", "pk", "convex")


def pack_tables(fused, fused_convex, mesh):
    """(layout, row table, mega width) of the three layouts the port packs."""
    return (("tet", mesh.tet_row, fused.LAYOUT_TET.width),
            ("pk", fused.row_table(mesh, fused.LAYOUT_PK), fused.LAYOUT_PK.width),
            ("convex", fused_convex.cx_table(mesh), fused_convex.WIDTH))


def pack_lanes(torch, n, nt, dtype, dev, seed):
    """Random lanes for the pack: pos, vel, tet int32 with about one in
    eight negative (escaped, absorbed, remote codes), active bool."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-1.0, 17.0, size=(n, 3)), dtype=dtype, device=dev)
    vel = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev)
    tet = rng.integers(0, nt, size=n)
    neg = rng.uniform(size=n) < 0.125
    tet[neg] = -rng.integers(1, 3 * nt, size=int(neg.sum()))
    act = torch.as_tensor(rng.uniform(size=n) > 0.1, device=dev)
    return pos, vel, torch.as_tensor(tet, dtype=torch.int32, device=dev), act


def unpack_plain(torch, fused, m):
    """The torch chain unpack_kernel replaces (PackedRun.result's before it):
    fresh pos, vel, tet, active and a zero disp of the mega ``m``."""
    pos, vel, tet, act = fused.unpack_state(m)
    return (pos.clone(), vel.clone(), tet, act,
            torch.zeros((m.shape[0], 3), dtype=m.dtype, device=m.device))


def same_outputs(torch, got, want):
    """Each tensor of ``got`` holds the bits of its twin in ``want``."""
    return all(bitwise_equal(torch, a, b) if a.is_floating_point() else
               a.shape == b.shape and bool(torch.equal(a, b)) for a, b in zip(got, want))


def pack_check(torch, fused, fused_cuda, tab, lanes, width, tag):
    """pack_kernel and unpack_kernel against their plain versions, bit for
    bit, on the lanes (pos, vel, tet, active) of a slice's state: what
    run_cycles hands them on that path.  Fails the phase where they differ."""
    m = fused_cuda.pack_rows(tab, *lanes, width)
    same = bitwise_equal(torch, m, fused.pack_state(tab, *lanes, width))
    same_u = same_outputs(torch, fused_cuda.unpack_rows(m), unpack_plain(torch, fused, m))
    log(f"[pack] {tag}: lanes={lanes[0].shape[0]} width={width} "
        f"negative_tets={int((lanes[2] < 0).sum())} pack_identical={int(same)} "
        f"unpack_identical={int(same_u)}")
    need(same and same_u, f"pack/unpack kernel != plain on {tag}")


def phase_pack(torch, cpt, fused, fused_convex, fused_cuda, dev, nside, n, slice_setup,
               gpu_line):
    """Phase 5e: pack_kernel and unpack_kernel (csrc/pack.cu) against their
    plain versions bit for bit on phase 3's box and on the north-star
    slice's state (and that state four times over), then their device ms
    there against the plain chain's and the byte bound.  Returns, by
    kernel, the row of the kernel table."""
    for dtype in (torch.float32, torch.float64):
        mesh = cpt.with_convex_rows(cpt.with_pk_rows(
            cpt.box_mesh(nside, nside, nside, dtype=dtype, device=dev)))
        for layout, tab, width in pack_tables(fused, fused_convex, mesh):
            for nn in (n, n - RAGGED):
                pos, vel, tet, act = pack_lanes(torch, nn, mesh.n_tets, dtype, dev, nn + width)
                wide = torch.zeros((nn, 9), dtype=dtype, device=dev)
                wide[:, 2:5] = pos
                before = (fused_cuda.pack_rows.launches, fused_cuda.unpack_rows.launches)
                same = True
                for p in (pos, wide[:, 2:5], pos.t().contiguous().t()):
                    m = fused_cuda.pack_rows(tab, p, vel, tet, act, width)
                    same &= bitwise_equal(torch, m, fused.pack_state(tab, p, vel, tet, act, width))
                outs = fused_cuda.unpack_rows(m)
                same_u = same_outputs(torch, outs, unpack_plain(torch, fused, m))
                # the mega's own head as pos and vel, as set_mesh hands it over
                m2 = fused_cuda.pack_rows(tab, m[:, 0:3], m[:, 3:6], outs[2], outs[3], width)
                same_r = bitwise_equal(torch, m2, m)
                launched = (fused_cuda.pack_rows.launches - before[0],
                            fused_cuda.unpack_rows.launches - before[1])
                log(f"[pack] parity {str(dtype)[6:]} {layout} lanes={nn} "
                    f"negative_tets={int((tet < 0).sum())} pack_identical={int(same)} "
                    f"unpack_identical={int(same_u)} repack_identical={int(same_r)} "
                    f"launches={launched}")
                need(same and same_u and same_r,
                     f"pack/unpack kernel != plain ({dtype}, {layout}, lanes={nn})")
                if dev.type == "cuda":
                    need(launched == (4, 1), f"pack parity launched {launched}, not (4, 1)")

    # the north-star slice: phase 5's mesh and seeds, the tets of a chained
    # state; then that state four times over, the coupled driver's 4e6 lanes
    mesh, st0, _, cfg = slice_setup
    st = cpt.run_cycles(mesh, st0, cfg, 10)
    tab, n_lanes, el = mesh.tet_row, st.n_particles, st.pos.element_size()
    lanes = (st.pos, st.vel, st.tet_id, st.active)
    pack_check(torch, fused, fused_cuda, tab, lanes, 32, "north-star slice, TetVelocity, "
               "after 10 cycles")
    pack_check(torch, fused, fused_cuda, tab, tuple(torch.cat([t] * 4) for t in lanes), 32,
               "north-star slice's state four times over")
    timer = Timer(torch, dev)
    m = fused_cuda.pack_rows(tab, *lanes, 32)

    def pack():
        fused_cuda.pack_rows(tab, *lanes, 32)

    def pack_torch():
        fused.pack_state(tab, *lanes, 32)

    before = (fused_cuda.pack_rows.launches, fused_cuda.unpack_rows.launches)
    times = {}
    for key, fn, plain in (("pack", pack, pack_torch),
                           ("unpack", lambda: fused_cuda.unpack_rows(m),
                            lambda: unpack_plain(torch, fused, m))):
        fn(), plain()    # warm-up
        # in turns plain, kernel, kernel, plain; each reading a graph of the
        # calls replayed, so the wrappers' host time (checks, the outputs'
        # allocation, about as long as the unpack kernel) is not read
        p_a = device_ms(torch, timer, plain, reps=10)
        k_a = device_ms(torch, timer, fn, reps=50)
        k_b = device_ms(torch, timer, fn, reps=50)
        p_b = device_ms(torch, timer, plain, reps=10)
        times[key] = ((k_a + k_b) / 2, (p_a + p_b) / 2, (p_a, k_a, k_b, p_b))
    rows = int(torch.unique(st.tet_id.clamp(min=0)).numel())
    # each input byte read once (one table row per distinct tet), each output
    # byte written once
    nbytes = {"pack": n_lanes * (6 * el + 4 + 1) + rows * 20 * el + n_lanes * 32 * el,
              "unpack": n_lanes * 8 * el + n_lanes * (9 * el + 4 + 1)}
    launched = (fused_cuda.pack_rows.launches - before[0],
                fused_cuda.unpack_rows.launches - before[1])
    table = {}
    for key, (k, pl, four) in times.items():
        bound = nbytes[key] / 3.35e12 * 1e3
        table[key] = dict(ms=k, plain_ms=pl, bytes=nbytes[key], bound_ms=bound, bound_by="bytes",
                          share=bound / k, copy_ms=copy_ms(torch, dev, timer, nbytes[key]))
        log(f"[pack] {gpu_line} | {key}_kernel_ms={k:.5f} ({four[1]:.5f}, {four[2]:.5f}) "
            f"{key}_plain_ms={pl:.5f} ({four[0]:.5f}, {four[3]:.5f}) MB={nbytes[key] / 1e6:.1f} "
            f"bound_ms={bound:.5f} share={bound / k:.3f} lanes={n_lanes} "
            f"distinct_rows={rows} (per-lane rows: {n_lanes * 20 * el / 1e6:.1f} MB)")
    both = times["pack"][0] + times["unpack"][0]
    bound = (nbytes["pack"] + nbytes["unpack"]) / 3.35e12 * 1e3
    log(f"[pack] {gpu_line} | call_kernels_ms={both:.5f} call_plain_ms="
        f"{times['pack'][1] + times['unpack'][1]:.5f} bound_ms={bound:.5f} "
        f"share={bound / both:.3f} launches={launched}")
    if dev.type == "cuda":
        # each kernel: one warm-up, then two readings of one warm-up + 50
        # captured calls
        need(launched == (103, 103), f"timed pack launches {launched}, not (103, 103)")
    return table


def phase_convex_slice(torch, cpt, fused, fused_convex, fused_cuda, dev, slice_setup,
                       n_cycles, errs, counts, rares, gpu_line):
    """Phase 5b: the convex slice (the bench's convex-default) through
    run_cycles, on phase 5's mesh and seeds."""
    mesh, st, n_in, bcfg = slice_setup
    t0 = time.perf_counter()
    mesh = cpt.with_convex_rows(mesh)
    t_rows = time.perf_counter() - t0
    n_particles = st.n_particles
    cfg = dataclasses.replace(bcfg, locate_mode="convex", brownian_rng="rbg_kernel")
    log(f"[convex-slice] tets={mesh.n_tets} particles={n_particles} inline_hops="
        f"{cfg.inline_hops} brownian_rng={cfg.brownian_rng} with_convex_rows_s={t_rows:.2f} "
        f"cx_tables_bytes={2 * mesh.tet_row_cx.numel() * mesh.tet_row_cx.element_size()}")
    st = cpt.run_cycles(mesh, st, cfg, 10)            # warm-up
    timer = Timer(torch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fused_cuda.convex_stream_cycle.launches = 0
    fused_cuda.convex_rare_resolve.launches = 0
    runs = []
    for _ in range(3):
        timer.start()
        st = cpt.run_cycles(mesh, st, cfg, n_cycles)
        runs.append(timer.stop())
    launches = {"convex_stream": fused_cuda.convex_stream_cycle.launches,
                "convex_rare": fused_cuda.convex_rare_resolve.launches}
    ms_cycle = [r / n_cycles for r in runs]
    med = float(np.median(ms_cycle))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[convex-slice] {gpu_line} | ms_per_cycle={['%.4f' % x for x in ms_cycle]} "
        f"median={med:.4f} particle_steps_per_s={n_particles / (med * 1e-3):.4e} "
        f"max_memory_allocated={peak} launches={launches}")
    if dev.type == "cuda":
        need(launches == {"convex_stream": 3 * n_cycles, "convex_rare": 3 * n_cycles},
             f"convex launch counts {launches} != {3 * n_cycles} per kernel")
    pack_check(torch, fused, fused_cuda, fused_convex.cx_table(mesh),
               (st.pos, st.vel, st.tet_id, st.active), fused_convex.WIDTH,
               "north-star slice, convex, after the timed runs")

    d = cpt.diagnostics(st)
    active = int(d["active"])
    bad = int((st.active & (st.tet_id < 0)).sum())
    blo, bhi = mesh.bounds_lo.to(st.dtype), mesh.bounds_hi.to(st.dtype)
    outside = int(((st.pos < blo - 1e-3) | (st.pos > bhi + 1e-3)).any(dim=1).sum())
    log(f"[convex-slice] active={active} seeds_in_domain={n_in} active_with_negative_tet={bad} "
        f"outside_bounds={outside} kinetic_energy={float(d['kinetic_energy']):.6e}")
    need(active == n_in and bad == 0 and outside == 0, "convex slice left the domain")
    need(bool(torch.isfinite(st.pos).all()), "non-finite positions (convex slice)")

    # one extra cycle through kernels and plain versions (Philox in the
    # kernel against philox_normals), and each kernel's time at this shape
    tab = fused_convex.cx_table(mesh)
    m0 = fused.pack_state(tab, st.pos, st.vel, st.tet_id, st.active, fused_convex.WIDTH)
    key = fused.philox_key(st.seed, st.step)
    same_s, err_s, same_r, err_r, npend, m1, d1, p1 = convex_cycle_pair(
        torch, fused_convex, fused_cuda, mesh, tab, m0, None, key,
        fused.philox_normals(key, n_particles, m0.dtype, dev), cfg, cfg.dt, fused)
    log(f"[convex-slice] extra cycle kernel vs plain: pending={npend} "
        f"pending_share={npend / n_particles:.4%} stream_identical={int(same_s)} "
        f"stream_max_abs_err={err_s:.3e} cycle_identical={int(same_r)} "
        f"cycle_max_abs_err={err_r:.3e}")
    need(same_s and same_r and max(err_s, err_r) <= POS_TOL_F32,
         "convex extra cycle kernel != plain")
    errs["convex_stream"] = max(errs["convex_stream"], err_s)
    errs["convex_rare"] = max(errs["convex_rare"], err_r)

    sa = convex_stream_args(cfg, cfg.dt, m0.dtype, fused)
    ra = convex_rare_args(cfg)
    work, pend, disp = m0.clone(), p1.clone(), d1.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)
        disp.copy_(d1)

    xi = fused._brownian_noise(st.seed, st.step, n_particles, m0.dtype, dev)
    # this run's row loads (interior crossers) and hops, for the bound
    cross = torch.empty_like(p1)
    ca = {a: sa[a] for a in ("dt", "sigma", "use_adv", "use_brown")}
    for name, noise, nk, m_after in (("convex_stream", "philox", key, m1),
                                     ("convex_stream_xi", "xi", None, None)):
        if m_after is None:
            m_after = m0.clone()
            fused_cuda.convex_stream_cycle(tab, m_after, xi, torch.empty_like(p1),
                                           torch.empty_like(d1), **sa)
        fused_cuda.convex_stream_crossers(tab, m0, None if nk else xi, cross, noise_key=nk,
                                          **ca)
        counts[name] = ("convex_stream", dict(n=n_particles, elem=m0.element_size(),
                                              noise=noise, row_loads=int(cross.sum()),
                                              hopped=moved(torch, m0, m_after)))
    counts["convex_rare"] = ("convex_rare", dict(n=n_particles, elem=m0.element_size(),
                                                 pending=int(p1.sum())))
    times = {}
    for name, fn, plain, restore in (
        ("convex_stream_xi",
         lambda: fused_cuda.convex_stream_cycle(tab, work, xi, pend, disp, **sa),
         lambda: fused_convex.convex_stream_plain(tab, work, xi, pend, disp, **sa),
         restore_stream),
        ("convex_stream",
         lambda: fused_cuda.convex_stream_cycle(tab, work, None, pend, disp, noise_key=key, **sa),
         lambda: fused_convex.convex_stream_plain(
             tab, work, fused.philox_normals(key, n_particles, work.dtype, dev), pend, disp,
             **sa),
         restore_stream),
    ):
        restore(), fn(), restore(), plain()    # warm-up
        p_a = time_calls(timer, plain, restore, 3)
        k_a = time_calls(timer, fn, restore, 20)
        k_b = time_calls(timer, fn, restore, 20)
        p_b = time_calls(timer, plain, restore, 3)
        times[name] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
        log(f"[convex-slice] {gpu_line} | {name}_kernel_ms={times[name][0]:.4f} "
            f"({k_a:.4f}, {k_b:.4f}) {name}_plain_ms={times[name][1]:.4f} "
            f"({p_a:.4f}, {p_b:.4f}) lanes={n_particles}")

    times["convex_rare"] = rare_row(
        torch, timer, lambda: fused_cuda.convex_rare_resolve(mesh, tab, work, disp, pend, **ra),
        lambda: fused_convex.convex_rare_plain(mesh, tab, work, disp, pend, **ra), restore_rare)
    t = times["convex_rare"]
    log(f"[convex-slice] {gpu_line} | convex_rare_kernel_ms={t[0]:.5f} (device: {BATCH} calls "
        f"replayed from a graph, restore subtracted) one_call_at_a_time_ms=({t[2][1]:.4f}, "
        f"{t[2][2]:.4f}) convex_rare_plain_ms={t[1]:.4f} ({t[2][0]:.4f}, {t[2][3]:.4f}) "
        f"lanes={n_particles}")

    def c_call(f, m, p, d, s):
        return f(tab.data_ptr(), mesh.tet_row_cx.data_ptr(), mesh.tet_a.data_ptr(),
                 mesh.tet_tinv.data_ptr(), mesh.tet_nbr.data_ptr(), mesh.tet_face_n.data_ptr(),
                 mesh.tet_face_d.data_ptr(), mesh.bd_escape.data_ptr(), m.data_ptr(),
                 d.data_ptr(), p.data_ptr(), m.shape[0], mesh.n_bd_faces, ra["max_hops"],
                 int(ra["reflect_wall"]), int(ra["bary_fix"]), ra["max_bounces"], s)

    rares.add("convex_rare", RareCase(
        m1, p1, d1, fused_convex.rare_chain(mesh, tab, m1, d1, p1, **ra),
        lambda m, p, d: fused_cuda.convex_rare_resolve(mesh, tab, m, d, p, **ra), c_call,
        "cpf_convex_rare_f32"))

    # the same slice with the noise drawn by torch.randn outside the kernel
    tcfg = dataclasses.replace(cfg, brownian_rng="threefry")
    st_t = cpt.run_cycles(mesh, st, tcfg, 10)         # warm-up
    timer.start()
    st_t = cpt.run_cycles(mesh, st_t, tcfg, n_cycles)
    ms_t = timer.stop() / n_cycles
    bad_t = int((st_t.active & (st_t.tet_id < 0)).sum())
    log(f"[convex-slice] {gpu_line} | brownian_rng=threefry ms_per_cycle={ms_t:.4f} "
        f"particle_steps_per_s={n_particles / (ms_t * 1e-3):.4e} (rbg_kernel median "
        f"{med:.4f}) active_with_negative_tet={bad_t}")
    need(bad_t == 0 and bool(torch.isfinite(st_t.pos).all()),
         "convex threefry slice left the domain")
    return launches, times, med


def phase_pk_slice(torch, cpt, fused, fused_cuda, tmesh, dev, nside, slice_setup, n_cycles,
                   errs, counts, rares, gpu_line):
    """Phase 5d: the north-star slice under VertexVelocity: phase 5's mesh and
    seeds, the vortex evaluated at the vertices, with_pk_rows."""
    ly = fused.LAYOUT_PK
    mesh, st, n_in, _ = slice_setup
    n = st.n_particles
    t0 = time.perf_counter()
    pts, _, _ = tmesh.box_points_tets(nside, nside, nside)
    mesh = cpt.with_pk_rows(cpt.replace_velocity(mesh, vert_vel=vortex(nside)(pts)))
    t_rows = time.perf_counter() - t0
    cfg = cpt.suggest_tuning(mesh, cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3,
                                                  velocity_interp="VertexVelocity"),
                             n_particles=n)
    tab = fused.row_table(mesh, ly)
    log(f"[pk-slice] tets={mesh.n_tets} particles={n} inline_hops={cfg.inline_hops} "
        f"inline_bounce={int(cfg.inline_bounce)} with_pk_rows_s={t_rows:.2f} "
        f"table_bytes={tab.numel() * tab.element_size()} (tet_row_pk32, the mesh's one copy) "
        f"mega_bytes={n * ly.width * tab.element_size()}")
    st = cpt.run_cycles(mesh, st, cfg, 10)            # warm-up
    timer = Timer(torch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for w in (fused_cuda.stream_cycle, fused_cuda.rare_resolve):
        w.launches = 0
    runs = []
    for _ in range(3):
        timer.start()
        st = cpt.run_cycles(mesh, st, cfg, n_cycles)
        runs.append(timer.stop())
    launches = {"stream_pk": fused_cuda.stream_cycle.launches,
                "rare_pk": fused_cuda.rare_resolve.launches}
    ms_cycle = [r / n_cycles for r in runs]
    med = float(np.median(ms_cycle))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[pk-slice] {gpu_line} | ms_per_cycle={['%.4f' % x for x in ms_cycle]} "
        f"median={med:.4f} particle_steps_per_s={n / (med * 1e-3):.4e} "
        f"max_memory_allocated={peak} launches={launches}")
    if dev.type == "cuda":
        need(launches == {"stream_pk": 3 * n_cycles, "rare_pk": 3 * n_cycles},
             f"pk slice launch counts {launches} != {3 * n_cycles} per kernel")
    domain_check(torch, cpt, mesh, st, n_in, "pk-slice")
    pack_check(torch, fused, fused_cuda, tab, (st.pos, st.vel, st.tet_id, st.active), ly.width,
               "north-star slice, VertexVelocity, after the timed runs")

    # one extra cycle through kernel and plain on the same inputs
    m0 = fused.pack_state(fused.row_table(mesh, ly), st.pos, st.vel, st.tet_id, st.active, ly.width)
    xi = fused._brownian_noise(st.seed, st.step, n, m0.dtype, dev)
    nkey = fused.philox_key(st.seed, st.step)
    sa = dict(stream_args(cfg, cfg.dt, m0.dtype, fused), ly=ly)
    ra = dict(rare_args(cfg), ly=ly)
    mk, mp = m0.clone(), m0.clone()
    pk = torch.empty(n, dtype=torch.uint8, device=dev)
    pp = torch.empty_like(pk)
    fused_cuda.stream_cycle(tab, mk, xi, pk, **sa)
    fused.stream_plain(tab, mp, xi, pp, **sa)
    same_s, err_s = compare(torch, mk, mp, pk, pp)
    m1, p1 = mp.clone(), pp.clone()
    n_el = m0.element_size()
    # rows loaded = lanes whose row changed (a floor when inline_hops > 1)
    hk = rows_changed(torch, m0, mk, ly.tab_w)
    counts["stream_pk"] = ("stream", dict(n=n, elem=n_el, noise="xi", hops=hk, hopped=hk,
                                          layout="pk"))
    mph = m0.clone()
    fused_cuda.stream_cycle(tab, mph, None, torch.empty_like(pk), noise_key=nkey, **sa)
    hph = rows_changed(torch, m0, mph, ly.tab_w)
    counts["stream_pk_philox"] = ("stream", dict(n=n, elem=n_el, noise="philox", hops=hph,
                                                 hopped=hph, layout="pk"))
    fused_cuda.rare_resolve(tab, mk, pk, mesh.bd_escape, **ra)
    counts["rare_pk"] = ("rare", dict(n=n, elem=n_el, pending=int(p1.sum()),
                                      moved=moved(torch, m1, mk), layout="pk"))
    fused.rare_plain(tab, mp, pp, mesh.bd_escape, **ra)
    same, err = compare(torch, mk, mp)
    log(f"[pk-slice] extra cycle kernel vs plain: hopped={hk} hop_share={hk / n:.4%} "
        f"pending={int(p1.sum())} pending_share={int(p1.sum()) / n:.4%} "
        f"stream_identical={int(same_s)} stream_max_abs_err={err_s:.3e} "
        f"cycle_identical={int(same)} cycle_max_abs_err={err:.3e}")
    need(same_s and same and max(err, err_s) <= POS_TOL_F32, "pk extra cycle kernel != plain")
    errs["stream_pk"] = max(errs["stream_pk"], err_s)
    errs["rare_pk"] = max(errs["rare_pk"], err)

    work, pend = m0.clone(), pk.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)

    times = {}
    for key, fn, plain, restore in (
        ("stream_pk", lambda: fused_cuda.stream_cycle(tab, work, xi, pend, **sa),
         lambda: fused.stream_plain(tab, work, xi, pend, **sa), restore_stream),
        ("stream_pk_philox",
         lambda: fused_cuda.stream_cycle(tab, work, None, pend, noise_key=nkey, **sa),
         lambda: fused.stream_plain(tab, work, fused.philox_normals(nkey, n, work.dtype, dev),
                                    pend, **sa), restore_stream),
    ):
        k_ms, p_ms, (p_a, k_a, k_b, p_b) = kernel_vs_plain_ms(timer, fn, plain, restore)
        times[key] = (k_ms, p_ms)
        log(f"[pk-slice] {gpu_line} | {key}_kernel_ms={k_ms:.4f} ({k_a:.4f}, {k_b:.4f}) "
            f"{key}_plain_ms={p_ms:.4f} ({p_a:.4f}, {p_b:.4f}) lanes={n}")
    rra = rare_args(cfg)
    times["rare_pk"] = rare_row(
        torch, timer, lambda: fused_cuda.rare_resolve(tab, work, pend, mesh.bd_escape, **ra),
        lambda: fused.rare_plain(tab, work, pend, mesh.bd_escape, **ra), restore_rare)
    rares.add("rare_pk", bary_rare_case(torch, fused, fused_cuda, tab, mesh, m1, p1, rra, ly,
                                        "cpf_rare_pk_f32"))
    t = times["rare_pk"]
    log(f"[pk-slice] {gpu_line} | rare_pk_kernel_ms={t[0]:.5f} (device: {BATCH} calls replayed "
        f"from a graph, restore subtracted) one_call_at_a_time_ms=({t[2][1]:.4f}, "
        f"{t[2][2]:.4f}) rare_pk_plain_ms={t[1]:.4f} ({t[2][0]:.4f}, {t[2][3]:.4f}) lanes={n}")

    # the same slice with the noise drawn inside the stream kernel
    rcfg = dataclasses.replace(cfg, brownian_rng="rbg_kernel")
    st_r = cpt.run_cycles(mesh, st, rcfg, 10)         # warm-up
    timer.start()
    st_r = cpt.run_cycles(mesh, st_r, rcfg, n_cycles)
    ms_r = timer.stop() / n_cycles
    bad_r = int((st_r.active & (st_r.tet_id < 0)).sum())
    log(f"[pk-slice] {gpu_line} | brownian_rng=rbg_kernel ms_per_cycle={ms_r:.4f} "
        f"particle_steps_per_s={n / (ms_r * 1e-3):.4e} (threefry median {med:.4f}) "
        f"active_with_negative_tet={bad_r}")
    need(bad_r == 0 and bool(torch.isfinite(st_r.pos).all()),
         "pk rbg_kernel slice left the domain")
    return launches, times


def phase_simple(torch, cpt, fused_cuda, tmesh, convert, dev, nside, n, n_cycles, gpu_line):
    """The simple engine (engine="simple": torch ops on the tensors' device,
    no kernel) against the cached engine on one injected noise stream,
    float64, VertexVelocity, every wall reflecting (the JAX package's gate
    of the two engines; with absorbing faces they differ by design in when
    an absorbed lane's active flag drops)."""
    payload = box_payload(tmesh, nside, np.float64, swirl(nside))
    mesh = cpt.with_pk_rows(convert.to_mesh(payload, dev))
    pos, vel, tet, act, _ = parity_lanes(torch, cpt, mesh, dev, nside, n, seed=9,
                                         dtype=torch.float64)
    st = dataclasses.replace(convert.to_state(pos.cpu().numpy(), tet.cpu().numpy(),
                                              dtype=np.float64, device=dev), vel=vel, active=act)
    rng = np.random.default_rng(10)
    noise = torch.as_tensor(rng.standard_normal((n_cycles, n, 3)), dtype=torch.float64,
                            device=dev)
    cfg = cpt.StepConfig(dt=0.3, diffusion_coeff=5e-3, inline_hops=2,
                         velocity_interp="VertexVelocity")
    timer = Timer(torch, dev)
    before = (fused_cuda.stream_cycle.launches, fused_cuda.rare_resolve.launches)
    timer.start()
    cached = cpt.run_cycles(mesh, st, cfg, n_cycles, noise=noise)
    ms_c = timer.stop() / n_cycles
    ran = (fused_cuda.stream_cycle.launches - before[0],
           fused_cuda.rare_resolve.launches - before[1])
    timer.start()
    simple = cpt.run_cycles(mesh, st, dataclasses.replace(cfg, engine="simple"), n_cycles,
                            noise=noise)
    ms_s = timer.stop() / n_cycles
    ran_s = (fused_cuda.stream_cycle.launches - before[0] - ran[0],
             fused_cuda.rare_resolve.launches - before[1] - ran[1])
    same = bool(torch.equal(cached.tet_id, simple.tet_id)
                and torch.equal(cached.active, simple.active))
    err = max(float((cached.pos - simple.pos).abs().max()),
              float((cached.vel - simple.vel).abs().max()))
    bounced = int((simple.tet_id != tet).sum())
    log(f"[simple] {gpu_line} | float64 VertexVelocity lanes={n} cycles={n_cycles} "
        f"lanes_in_a_new_tet={bounced} cached_equals_simple={int(same)} "
        f"max_abs_err={err:.3e} "
        f"simple_ms_per_cycle={ms_s:.3f} cached_ms_per_cycle={ms_c:.3f} (the first cycles "
        f"of each, warm-up included) cached_launches={ran} simple_launches={ran_s}")
    need(same and err <= POS_TOL_F64, "cached engine != simple engine")
    need(bounced > 0 and simple.device == dev, "the simple engine moved no lane")
    if dev.type == "cuda":
        need(ran == (n_cycles, n_cycles) and ran_s == (0, 0),
             f"engines launched {ran} and {ran_s} Pk kernels")
        # without its table the cached engine raises on the card: no silent simple engine
        try:
            cpt.run_cycles(convert.to_mesh(payload, dev), st, cfg, 1)
        except ValueError as e:
            need("with_pk_rows" in str(e), f"unexpected error without Pk rows: {e}")
        else:
            need(False, "run_cycles ran VertexVelocity on the card without with_pk_rows")


def flag_err(torch, a, b):
    """Largest |a - b| of two [n] uint8 flag arrays, as a float."""
    return float((a.to(torch.int16) - b.to(torch.int16)).abs().max()) if a.numel() else 0.0


def compact_stages(fused, fused_convex, fused_cuda, convex, tab, xi, kw, bounce_on, esc_on):
    """(flag pass, plain flags, apply pass, plain apply) of the compacted
    hop gather for one locator; ``kw`` is fused.stream_kwargs; the apply
    calls take (m, pending, disp, admit) and ignore disp in the bary mode."""
    if convex:
        return (lambda m, c: fused_cuda.convex_stream_crossers(tab, m, xi, c, **kw),
                lambda m, c: fused_convex.convex_stream_plain(tab, m, xi, None, None, n_hops=1,
                                                              crossers=c, **kw),
                lambda m, p, d, a: fused_cuda.convex_stream_cycle(tab, m, xi, p, d, n_hops=1,
                                                                  admit=a, **kw),
                lambda m, p, d, a: fused_convex.convex_stream_plain(tab, m, xi, p, d, n_hops=1,
                                                                    admit=a, **kw))
    bk = dict(kw, bounce_on=bounce_on, esc_on=esc_on, n_hops=1)
    return (lambda m, c: fused_cuda.stream_crossers(tab, m, xi, c, **kw),
            lambda m, c: fused.stream_plain(tab, m, xi, None, bounce_on=False, esc_on=False,
                                            n_hops=1, crossers=c, **kw),
            lambda m, p, d, a: fused_cuda.stream_cycle(tab, m, xi, p, admit=a, **bk),
            lambda m, p, d, a: fused.stream_plain(tab, m, xi, p, admit=a, **bk))


def phase_admit_sizes(torch, fused, fused_cuda, dev, lane_counts, errs):
    """Phase 3d, first part, before anything is timed: hop_admit_kernel
    against hop_admit_plain at tiny, ragged and large lane counts, with no
    flag set, every flag set and random flags, at capacities 0, a third of
    the groups, the groups and beyond; one scratch buffer serves every call
    and must come back zeroed."""
    rng = np.random.default_rng(12)
    scratch = fused_cuda.hop_admit_scratch(max(lane_counts), dev)
    for n in lane_counts:
        groups = -(-n // 4)
        cases = 0
        for rate in (0.0, 1.0, 0.3):
            c = torch.as_tensor((rng.uniform(size=n) < rate).astype(np.uint8), device=dev)
            for capb in sorted({0, groups // 3, groups, groups + 5}):
                ak = torch.full((n,), 7, dtype=torch.uint8, device=dev)
                ap = torch.empty_like(ak)
                fused_cuda.hop_admit(c, ak, capb=capb, scratch=scratch)
                fused.hop_admit_plain(c, ap, capb=capb)
                need(torch.equal(ak, ap),
                     f"hop_admit_kernel != plain (lanes={n} rate={rate} capb={capb})")
                errs["hop_admit"] = max(errs["hop_admit"], flag_err(torch, ak, ap))
                cases += 1
        clean = int(scratch.abs().sum()) == 0
        log(f"[admit] lanes={n} cases={cases} admit_identical=1 scratch_left_zeroed={int(clean)}")
        need(clean, f"hop_admit_kernel left its scratch dirty (lanes={n})")


def phase_compact(torch, cpt, fused, fused_convex, fused_cuda, tmesh, convert, dev, nside, n,
                  errs):
    """Phase 3d: the compacted hop gather against its plain versions and
    against the uncompacted cycle."""
    payload = box_payload(tmesh, nside, np.float32, swirl(nside))
    base = convert.to_mesh(payload, dev)
    pos, vel, tet, act, xi = parity_lanes(torch, cpt, base, dev, nside, n, seed=8)
    u8 = dict(dtype=torch.uint8, device=dev)
    for convex in (False, True):
        for esc in (False, True):
            mesh = tmesh.set_boundary_escape(base, [1] if esc else [])
            if convex:
                mesh = cpt.with_convex_rows(mesh)
                tab = fused_convex.cx_table(mesh)
                m0 = fused.pack_state(tab, pos, vel, tet, act, fused_convex.WIDTH)
                cycle = fused_convex.mega_cycle
                args = (mesh, tab)
            else:
                tab = mesh.tet_row
                m0 = fused.pack_state(fused.row_table(mesh), pos, vel, tet, act)
                cycle = fused.mega_cycle
                args = (mesh,)
            for frac in (1.0, 0.02):
                cfg = cpt.StepConfig(dt=0.3 if convex else 0.2, diffusion_coeff=5e-3,
                                     escape_faces=esc, hop_compact=4, hop_compact_frac=frac,
                                     locate_mode="convex" if convex else "bary")
                kw = fused.stream_kwargs(cfg, cfg.dt, torch.float32)
                flags_k, flags_p, apply_k, apply_p = compact_stages(
                    fused, fused_convex, fused_cuda, convex, tab, xi, kw, True, esc)
                ck, cp, ak, ap = (torch.empty(n, **u8) for _ in range(4))
                flags_k(m0, ck)
                flags_p(m0, cp)
                capb = fused.hop_capacity(n, frac)
                fused_cuda.hop_admit(ck, ak, capb=capb)
                fused.hop_admit_plain(ck, ap, capb=capb)
                mk, mp = m0.clone(), m0.clone()
                pk, pp = torch.empty(n, **u8), torch.empty(n, **u8)
                dk = torch.empty((n, 3), dtype=torch.float32, device=dev)
                dp = torch.empty_like(dk)
                apply_k(mk, pk, dk, ak)
                apply_p(mp, pp, dp, ak)
                same_s, err_s = compare(torch, mk, mp, pk, pp)
                if convex:
                    err_s = max(err_s, float((dk - dp).abs().max()))
                # whole cycles through the kernels: compacted against uncompacted
                mc = cycle(*args, m0.clone(), 0, 0, cfg, cfg.dt, noise=xi)
                mu = cycle(*args, m0.clone(), 0, 0, dataclasses.replace(cfg, hop_compact=0),
                           cfg.dt, noise=xi)
                same_c = bool(torch.equal(mc[:, :8], mu[:, :8]))
                groups = ck.view(-1, 4).sum(dim=1)
                n_cross, n_adm = int(ck.sum()), int(ak.sum())
                log(f"[compact] {'convex' if convex else 'bary'} escape={int(esc)} frac={frac} "
                    f"capb={capb} crossers={n_cross} pending_groups={int((groups > 0).sum())} "
                    f"admitted={n_adm} overflow={n_cross - n_adm} pending={int(pp.sum())} "
                    f"flags_identical={int(torch.equal(ck, cp))} "
                    f"admit_identical={int(torch.equal(ak, ap))} apply_identical={int(same_s)} "
                    f"apply_max_abs_err={err_s:.3e} cycle_equals_uncompacted={int(same_c)}")
                need(n_cross > n_adm, "compact case has no overflow")
                need(torch.equal(ck, cp), f"crossing flags != plain ({convex=} {esc=} {frac=})")
                need(torch.equal(ak, ap), f"hop_admit_kernel != plain ({convex=} {esc=} {frac=})")
                errs["hop_admit"] = max(errs["hop_admit"], flag_err(torch, ak, ap))
                need(same_s and err_s <= POS_TOL_F32,
                     f"compacted stream kernel != plain ({convex=} {esc=} {frac=})")
                need(same_c, f"compacted cycle != uncompacted cycle ({convex=} {esc=} {frac=})")
                key = "convex_stream" if convex else "stream"
                errs[key] = max(errs[key], err_s)


def macro_plain(torch, fused, mesh, m, xi, cfg, dt):
    """One macro cycle through the plain versions (fused.mega_macro's trips)
    on m's device; xi [k, n, 3] or None."""
    k, n, dev = cfg.macro_cycles, m.shape[0], m.device
    kw = dict(fused.stream_kwargs(cfg, dt, m.dtype), k=k)
    phase = torch.zeros(n, dtype=torch.uint8, device=dev)
    pend, crossers, admit = (torch.empty_like(phase) for _ in range(3))
    for trip in range(k):
        if trip:
            fused.macro_stream_plain(mesh.tet_row, m, xi, phase, None, bounce_on=False,
                                     esc_on=False, crossers=crossers, **kw)
            fused.hop_admit_plain(crossers, admit,
                                  capb=fused.hop_capacity(n, fused.trip_fraction(cfg, trip)))
        fused.macro_stream_plain(mesh.tet_row, m, xi, phase, pend,
                                 bounce_on=cfg.reflect_wall and cfg.inline_bounce,
                                 esc_on=cfg.escape_faces, admit=admit if trip else None, **kw)
        fused.rare_plain(mesh.tet_row, m, pend, mesh.bd_escape, **rare_args(cfg))
    return m


def macro_noise(torch, fused, cfg, seed, step, n, dev, dtype=None):
    """(noise for mega_macro, the same noise for the plain versions) of one
    macro cycle: threefry [k, n, 3] injected, or the Philox stream drawn in
    the kernel and by philox_normals."""
    k = cfg.macro_cycles
    dtype = torch.float32 if dtype is None else dtype
    if cfg.brownian_rng == "threefry":
        xi = torch.stack([fused._brownian_noise(seed, step + j, n, dtype, dev)
                          for j in range(k)])
        return xi, xi
    return None, torch.stack([fused.philox_normals(fused.philox_key(seed, step + j), n,
                                                   dtype, dev) for j in range(k)])


def macro_passes_check(torch, fused, fused_cuda, mesh, m0, xi, xi_plain, key, cfg, errs, tag):
    """The three passes of macro_stream_kernel against macro_stream_plain,
    one call each, on phase vectors a macro cycle would not give the small
    case: random phases, runs of whole blocks finished (with one block
    holding a single working lane, and the last lanes finished), and no
    lane working.  Returns the macro_stream launches it made."""
    n, dev, k = m0.shape[0], m0.device, cfg.macro_cycles
    tol = POS_TOL_F32 if m0.dtype == torch.float32 else POS_TOL_F64
    rng = np.random.default_rng(13)
    mixed = torch.as_tensor(rng.integers(0, k + 1, n).astype(np.uint8), device=dev)
    runs = mixed.clone()
    if n >= 2048:
        runs[256:1024] = k
        runs[1280:1536] = k
        runs[1280 + 7] = 1
        runs[-300:] = k
    kw = dict(fused.stream_kwargs(cfg, cfg.dt, m0.dtype), k=k)
    bk = dict(kw, bounce_on=cfg.reflect_wall and cfg.inline_bounce, esc_on=cfg.escape_faces)
    launched = 0
    for name, ph in (("mixed", mixed), ("runs_finished", runs),
                     ("none_working", torch.full_like(mixed, k))):
        ck = torch.full_like(ph, 9)
        cp = torch.empty_like(ph)
        fused_cuda.macro_crossers(mesh.tet_row, m0, xi, ph, ck, noise_key=key, **kw)
        fused.macro_stream_plain(mesh.tet_row, m0, xi_plain, ph, None, bounce_on=False,
                                 esc_on=False, crossers=cp, **kw)
        need(torch.equal(ck, cp), f"macro crossing flags != plain ({tag} {name})")
        ad = torch.empty_like(ph)
        fused.hop_admit_plain(cp, ad, capb=max(int(cp.view(-1).sum()) // 8, 1))
        for adm in (None, ad):
            mk, mp = m0.clone(), m0.clone()
            phk, php = ph.clone(), ph.clone()
            pk, pp = torch.full_like(ph, 9), torch.empty_like(ph)
            fused_cuda.macro_stream(mesh.tet_row, mk, xi, phk, pk, noise_key=key, admit=adm, **bk)
            fused.macro_stream_plain(mesh.tet_row, mp, xi_plain, php, pp, admit=adm, **bk)
            launched += 1
            same, err = compare(torch, mk, mp, pk, pp)
            same = same and bool(torch.equal(phk, php))
            err = max(err, float((mk[:, 8:28] - mp[:, 8:28]).abs().max()))
            need(same and err <= tol, f"macro_stream_kernel != plain ({tag} {name} "
                                      f"admit={adm is not None}: identical={same} err={err:.3e})")
            errs["macro"] = max(errs["macro"], err)
        log(f"[macro] passes {tag} phases={name} working={int((ph < k).sum())} "
            f"crossers={int(cp.sum())} flags_identical=1 whole_identical=1 admitted_identical=1")
    return launched


def phase_macro(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs):
    """Phase 3e: macro cycles through the kernels against the plain versions
    and against k per-cycle kernel cycles, at n and a ragged n - RAGGED
    lanes; float64 for k = 4 with escape faces; and the kernel's passes on
    phase vectors with whole blocks finished."""
    seed, step = 77, 40
    before = fused_cuda.macro_stream.launches
    expected = 0
    for np_dtype, dtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
        base = convert.to_mesh(box_payload(tmesh, nside, np_dtype, swirl(nside)), dev)
        pos, vel, _, act, _ = parity_lanes(torch, cpt, base, dev, nside, n, seed=9)
        pos, vel = pos.to(dtype), vel.to(dtype)
        tet = cpt.locate_seeds(base, cpt.build_grid_locator(base), pos)
        tol = POS_TOL_F32 if dtype == torch.float32 else POS_TOL_F64
        for nn, k, rng_mode, esc in itertools.product((n, n - RAGGED), (2, 4),
                                                      ("threefry", "rbg_kernel"), (False, True)):
            if dtype == torch.float64 and not (k == 4 and esc):
                continue
            mesh = tmesh.set_boundary_escape(base, [1] if esc else [])
            m0 = fused.pack_state(fused.row_table(mesh), pos[:nn], vel[:nn], tet[:nn], act[:nn])
            cfg = cpt.StepConfig(dt=0.2, diffusion_coeff=5e-3, escape_faces=esc,
                                 macro_cycles=k, brownian_rng=rng_mode)
            xi, xi_plain = macro_noise(torch, fused, cfg, seed, step, nn, dev, dtype)
            mk = fused.mega_macro(mesh, m0.clone(), seed, step, cfg, cfg.dt, noise=xi)
            expected += k
            mp = macro_plain(torch, fused, mesh, m0.clone(), xi_plain, cfg, cfg.dt)
            same_p, err_p = compare(torch, mk, mp)
            mc = m0.clone()
            for j in range(k):
                fused.mega_cycle(mesh, mc, seed, step + j, cfg, cfg.dt,
                                 noise=None if xi is None else xi[j])
            same_c = bool(torch.equal(mk[:, :8], mc[:, :8]))
            moved = float((mk[:, 6] != m0[:, 6]).float().mean())
            tag = (f"{str(dtype).split('.')[1]} lanes={nn} k={k} rng={rng_mode} "
                   f"escape={int(esc)}")
            log(f"[macro] {tag} moved_share={moved:.4f} "
                f"plain_identical={int(same_p)} plain_max_abs_err={err_p:.3e} "
                f"equals_{k}_cycles={int(same_c)}")
            need(same_p and err_p <= tol, f"macro kernels != plain ({tag})")
            need(same_c, f"macro cycle != {k} per-cycle kernel cycles ({tag})")
            errs["macro"] = max(errs["macro"], err_p)
            if k == 4 and esc:
                key = None if xi is not None else fused.philox_key(seed, step)
                expected += macro_passes_check(torch, fused, fused_cuda, mesh, m0, xi, xi_plain,
                                               key, cfg, errs, tag)
    if dev.type == "cuda":
        need(fused_cuda.macro_stream.launches - before == expected,
             "phase 3e did not run macro_stream_kernel")


COUNTED = ("stream_cycle", "stream_crossers", "rare_resolve", "convex_stream_cycle",
           "convex_stream_crossers", "convex_rare_resolve", "hop_admit", "macro_stream",
           "macro_crossers", "pack_rows", "unpack_rows")


def counted_run(torch, cpt, fused_cuda, timer, mesh, st, cfg, n_cycles):
    """(state, ms, host ms, launches by wrapper) of one run_cycles call,
    every launch count set to 0 just before it.  The host ms is the host's
    time to enqueue the run (no synchronisation): where it equals ms, the
    host's launch rate bounds the run, not the card."""
    for name in COUNTED:
        getattr(fused_cuda, name).launches = 0
    timer.start()
    h0 = time.perf_counter()
    st = cpt.run_cycles(mesh, st, cfg, n_cycles)
    host_ms = (time.perf_counter() - h0) * 1e3
    ms = timer.stop()
    return st, ms, host_ms, {name: getattr(fused_cuda, name).launches for name in COUNTED}


def domain_check(torch, cpt, mesh, st, n_in, tag):
    d = cpt.diagnostics(st)
    active = int(d["active"])
    bad = int((st.active & (st.tet_id < 0)).sum())
    blo, bhi = mesh.bounds_lo.to(st.dtype), mesh.bounds_hi.to(st.dtype)
    outside = int(((st.pos < blo - 1e-3) | (st.pos > bhi + 1e-3)).any(dim=1).sum())
    log(f"[{tag}] active={active} seeds_in_domain={n_in} active_with_negative_tet={bad} "
        f"outside_bounds={outside} kinetic_energy={float(d['kinetic_energy']):.6e}")
    need(active == n_in and bad == 0 and outside == 0, f"{tag} left the domain")
    need(bool(torch.isfinite(st.pos).all()), f"non-finite positions ({tag})")


def need_launches(dev, got, want, tag):
    if dev.type == "cuda":
        nonzero = {k: v for k, v in got.items() if v}
        need(nonzero == want, f"{tag} launch counts {nonzero} != {want}")


def kernel_vs_plain_ms(timer, fn, plain, restore, reps=20, plain_reps=3):
    """(kernel ms, plain ms, the four means) in turns plain, kernel, kernel,
    plain, each call after restore()."""
    restore(), fn(), restore(), plain()    # warm-up
    p_a = time_calls(timer, plain, restore, plain_reps)
    k_a = time_calls(timer, fn, restore, reps)
    k_b = time_calls(timer, fn, restore, reps)
    p_b = time_calls(timer, plain, restore, plain_reps)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, (p_a, k_a, k_b, p_b)


BATCH = 200    # calls in one reading of a kernel of a few microseconds


def batch_ms(timer, fn, reps=BATCH):
    """Mean ms of fn() over reps calls back to back between one pair of
    events.  The host needs about 0.02 ms to enqueue one launch through a
    wrapper, so for a kernel shorter than that this reads the host."""
    fn()
    timer.start()
    for _ in range(reps):
        fn()
    return timer.stop() / reps


def device_ms(torch, timer, fn, restore=None, reps=BATCH):
    """The device's ms per call of fn(), with the host out of the reading:
    reps calls are captured into one CUDA graph and the graph is replayed
    between a pair of events.  With ``restore`` (a device copy that resets
    fn's inputs) the graph holds reps x (restore, fn), and a second graph
    of reps x restore is subtracted.  A measuring device only (the port's
    one graph is the pressure solve's CG iteration, ``fv._pcg``).  On the
    CPU (rehearsal) the same loops on the host clock."""
    def replay(body):
        body()
        if not timer.cuda:
            return batch_ms(timer, body, reps)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()
        timer.start()
        graph.replay()
        return timer.stop() / reps

    if restore is None:
        return replay(fn)
    return replay(lambda: (restore(), fn())) - replay(restore)


def launch_floor_ms(torch, fused_cuda, timer, dev):
    """(device ms, host ms) of a launch that does next to nothing, the
    floor that binds a kernel of a few megabytes: hop_admit_kernel on 4
    lanes (one block, one 16 B of work).  Device: BATCH launches replayed
    from a graph (device_ms).  Host: BATCH launches through the wrapper
    back to back, as every kernel here is launched."""
    c = torch.zeros(4, dtype=torch.uint8, device=dev)
    a = torch.empty_like(c)
    scratch = fused_cuda.hop_admit_scratch(4, dev)

    def fn():
        fused_cuda.hop_admit(c, a, capb=1, scratch=scratch)

    return device_ms(torch, timer, fn), batch_ms(timer, fn)


def phase_macro_slice(torch, cpt, fused, fused_convex, fused_cuda, dev, slice_setup, n_cycles,
                      ms_per_cycle, errs, counts, gpu_line):
    """Phase 5c, first part: the slice with macro_cycles=4."""
    mesh, st0, n_in, bcfg = slice_setup
    n = st0.n_particles
    timer = Timer(torch, dev)
    k = 4
    cfg = dataclasses.replace(bcfg, macro_cycles=k)
    st = cpt.run_cycles(mesh, st0, cfg, 2 * k)         # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs, host, launches = [], [], None
    for _ in range(3):
        st, ms, host_ms, got = counted_run(torch, cpt, fused_cuda, timer, mesh, st, cfg,
                                           n_cycles)
        runs.append(ms / n_cycles)
        host.append(host_ms / n_cycles)
        launches = got if launches is None else {a: launches[a] + got[a] for a in got}
    med = float(np.median(runs))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[macro-slice] {gpu_line} | macro_cycles={k} ms_per_cycle={['%.4f' % x for x in runs]} "
        f"median={med:.4f} host_enqueue_ms_per_cycle={['%.4f' % x for x in host]} "
        f"particle_steps_per_s={n / (med * 1e-3):.4e} (per-cycle threefry "
        f"median {ms_per_cycle:.4f}) max_memory_allocated={peak} launches="
        f"{ {a: v for a, v in launches.items() if v} }")
    macs = 3 * (n_cycles // k)
    need_launches(dev, launches, {"macro_stream": k * macs, "macro_crossers": (k - 1) * macs,
                                  "hop_admit": (k - 1) * macs, "rare_resolve": k * macs,
                                  "pack_rows": 3, "unpack_rows": 3}, "macro slice")
    domain_check(torch, cpt, mesh, st, n_in, "macro-slice")
    rcfg = dataclasses.replace(cfg, brownian_rng="rbg_kernel")
    st_r = cpt.run_cycles(mesh, st, rcfg, 2 * k)       # warm-up
    st_r, ms_r, host_r, _ = counted_run(torch, cpt, fused_cuda, timer, mesh, st_r, rcfg,
                                        n_cycles)
    log(f"[macro-slice] {gpu_line} | macro_cycles={k} brownian_rng=rbg_kernel "
        f"ms_per_cycle={ms_r / n_cycles:.4f} "
        f"host_enqueue_ms_per_cycle={host_r / n_cycles:.4f} "
        f"particle_steps_per_s={n / (ms_r / n_cycles * 1e-3):.4e}")
    domain_check(torch, cpt, mesh, st_r, n_in, "macro-slice rbg_kernel")

    # one macro cycle through kernels and plain versions on the same inputs
    m0 = fused.pack_state(fused.row_table(mesh), st.pos, st.vel, st.tet_id, st.active)
    xi, _ = macro_noise(torch, fused, cfg, st.seed, st.step, n, dev)
    mk = fused.mega_macro(mesh, m0.clone(), st.seed, st.step, cfg, cfg.dt, noise=xi)
    mp = macro_plain(torch, fused, mesh, m0.clone(), xi, cfg, cfg.dt)
    same, err = compare(torch, mk, mp)
    log(f"[macro-slice] one macro cycle kernel vs plain: identical={int(same)} "
        f"max_abs_err={err:.3e}")
    need(same and err <= POS_TOL_F32, "macro slice: kernels != plain")
    errs["macro"] = max(errs["macro"], err)

    # times at this shape: trip 0 of macro_stream_kernel (xi and Philox), and
    # hop_admit_kernel on trip 1's crossing flags
    skw = dict(fused.stream_kwargs(cfg, cfg.dt, m0.dtype), k=k,
               bounce_on=cfg.reflect_wall and cfg.inline_bounce, esc_on=cfg.escape_faces)
    work = m0.clone()
    phase = torch.zeros(n, dtype=torch.uint8, device=dev)
    pend, crossers, admit = (torch.empty_like(phase) for _ in range(3))
    nkey = fused.philox_key(st.seed, st.step)

    def philox_k():
        return torch.stack([fused.philox_normals(fused.philox_key(st.seed, st.step + j), n,
                                                 m0.dtype, dev) for j in range(k)])

    def restore():
        work.copy_(m0)
        phase.zero_()

    times = {}
    for name, fn, plain in (
        ("macro", lambda: fused_cuda.macro_stream(mesh.tet_row, work, xi, phase, pend, **skw),
         lambda: fused.macro_stream_plain(mesh.tet_row, work, xi, phase, pend, **skw)),
        ("macro_philox",
         lambda: fused_cuda.macro_stream(mesh.tet_row, work, None, phase, pend, noise_key=nkey,
                                         **skw),
         lambda: fused.macro_stream_plain(mesh.tet_row, work, philox_k(), phase, pend, **skw)),
    ):
        times[name] = kernel_vs_plain_ms(timer, fn, plain, restore)
    # trip 0's sub-steps drawn (a lane stopped at sub-step j has phase j + 1)
    # and hops, for the bound
    for name, noise, xk in (("macro_philox", "philox", None), ("macro", "xi", xi)):
        restore()
        fused_cuda.macro_stream(mesh.tet_row, work, xk, phase, pend,
                                noise_key=None if xk is not None else nkey, **skw)
        hw = rows_changed(torch, m0, work, 20)
        counts[name] = ("macro_stream", dict(n=n, elem=m0.element_size(), noise=noise,
                                             working=n, substeps=int(phase.sum()),
                                             hops=hw, hopped=hw))
    counts["hop_admit"] = ("hop_admit", dict(n=n))
    stopped0, pend0 = int((phase < k).sum()), int(pend.sum())

    # trips 1..k-1, each on the state it really sees (the trip before and its
    # rare stage have run): the flag pass and the apply pass each on its own;
    # the kernel's time is the device's (device_ms), the bracketed pair one
    # call at a time, which for these short kernels reads the host
    ckw = {a: skw[a] for a in ("k", "dt", "sigma", "use_adv", "use_brown")}
    scratch = fused_cuda.hop_admit_scratch(n, dev)
    for trip in range(1, k):
        fused_cuda.rare_resolve(mesh.tet_row, work, pend, mesh.bd_escape, **rare_args(cfg))
        m_t, ph_t = work.clone(), phase.clone()
        capb = fused.hop_capacity(n, fused.trip_fraction(cfg, trip))

        def restore_t():
            work.copy_(m_t)
            phase.copy_(ph_t)

        def flags_k():
            fused_cuda.macro_crossers(mesh.tet_row, work, xi, phase, crossers, **ckw)

        def flags_p():
            fused.macro_stream_plain(mesh.tet_row, work, xi, phase, None, bounce_on=False,
                                     esc_on=False, crossers=crossers, **ckw)

        one = kernel_vs_plain_ms(timer, flags_k, flags_p, lambda: None, reps=5)
        cp = crossers.clone()          # the plain flags (timed last)
        times[f"macro_crossers_t{trip}"] = (device_ms(torch, timer, flags_k), one[1], one[2])
        need(torch.equal(crossers, cp), f"macro slice trip {trip}: crossing flags != plain")
        if trip == 1:
            # hop_admit_kernel on trip 1's flags: one call at a time, and
            # BATCH calls back to back (the table's figure)
            def admit_k():
                fused_cuda.hop_admit(crossers, admit, capb=capb, scratch=scratch)

            single = kernel_vs_plain_ms(
                timer, admit_k, lambda: fused.hop_admit_plain(crossers, admit, capb=capb),
                lambda: None)
            host = batch_ms(timer, admit_k)
            graphs = [device_ms(torch, timer, admit_k) for _ in range(2)]
            times["hop_admit"] = (sum(graphs) / 2, single[1],
                                  (single[2][0], graphs[0], graphs[1], single[2][3]))
            log(f"[macro-slice] {gpu_line} | hop_admit_kernel lanes={n} one call at a time "
                f"ms={single[0]:.4f} ({single[2][1]:.4f}, {single[2][2]:.4f}); {BATCH} calls "
                f"back to back ms_per_call={host:.4f}; {BATCH} calls replayed from a graph "
                f"ms_per_call={times['hop_admit'][0]:.4f} ({graphs[0]:.4f}, {graphs[1]:.4f})")
        fused_cuda.hop_admit(crossers, admit, capb=capb, scratch=scratch)
        ak = admit.clone()
        fused.hop_admit_plain(crossers, admit, capb=capb)
        need(torch.equal(ak, admit), f"macro slice trip {trip}: hop_admit_kernel != plain")
        errs["hop_admit"] = max(errs["hop_admit"], flag_err(torch, ak, admit))

        def apply_k():
            fused_cuda.macro_stream(mesh.tet_row, work, xi, phase, pend, admit=ak, **skw)

        one = kernel_vs_plain_ms(
            timer, apply_k,
            lambda: fused.macro_stream_plain(mesh.tet_row, work, xi, phase, pend, admit=ak,
                                             **skw), restore_t, reps=5)
        mp, php, ppl = work.clone(), phase.clone(), pend.clone()     # plain, timed last
        times[f"macro_admitted_t{trip}"] = (device_ms(torch, timer, apply_k, restore_t, reps=50),
                                            one[1], one[2])
        restore_t()
        fused_cuda.macro_stream(mesh.tet_row, work, xi, phase, pend, admit=ak, **skw)
        same_t, err_t = compare(torch, work, mp, pend, ppl)
        need(same_t and torch.equal(phase, php) and err_t <= POS_TOL_F32,
             f"macro slice trip {trip}: apply pass != plain")
        errs["macro"] = max(errs["macro"], err_t)
        working = int((ph_t < k).sum())
        substeps = int((phase.to(torch.int32) - ph_t.to(torch.int32)).sum())
        hw = rows_changed(torch, m_t, work, 20)
        shape = dict(n=n, elem=m0.element_size(), noise="xi", working=working,
                     substeps=substeps)
        counts[f"macro_crossers_t{trip}"] = ("macro_stream", dict(shape, pass_="crossers"))
        counts[f"macro_admitted_t{trip}"] = ("macro_stream", dict(shape, pass_="admitted",
                                                                  hops=hw, hopped=hw))
        log(f"[macro-slice] trip {trip}: working={working} ({working / n:.4%}) "
            f"substeps={substeps} crossers={int(crossers.sum())} admitted={int(ak.sum())} "
            f"capb={capb} hops={hw} pending={int(pend.sum())} still_working="
            f"{int((phase < k).sum())}")
    log(f"[macro-slice] trip 0: stopped_share={stopped0 / n:.4%} pending_share="
        f"{pend0 / n:.4%}")
    for name, (t_k, t_p, parts) in times.items():
        log(f"[macro-slice] {gpu_line} | {name}_kernel_ms={t_k:.4f} ({parts[1]:.4f}, "
            f"{parts[2]:.4f}) {name}_plain_ms={t_p:.4f} ({parts[0]:.4f}, {parts[3]:.4f}) "
            f"lanes={n}")

    return launches, times


def phase_compact_slice(torch, cpt, fused, fused_convex, fused_cuda, dev, slice_setup, n_cycles,
                        convex, errs, counts, gpu_line):
    """Phase 5c, second part: one 200-cycle run of the slice (bary) or of
    the convex-default with hop_compact=4, the compacted stream's time
    against its plain version, and the flag pass and the apply pass each on
    its own; returns their times by timing key."""
    mesh, st0, n_in, bcfg = slice_setup
    n = st0.n_particles
    timer = Timer(torch, dev)
    tag = "convex-compact-slice" if convex else "compact-slice"
    ccfg = dataclasses.replace(bcfg, hop_compact=4)
    cmesh = mesh
    if convex:
        cmesh = cpt.with_convex_rows(mesh)
        ccfg = dataclasses.replace(ccfg, locate_mode="convex", brownian_rng="rbg_kernel")
    st_c = cpt.run_cycles(cmesh, st0, ccfg, 10)    # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    st_c, ms_c, host_c, got = counted_run(torch, cpt, fused_cuda, timer, cmesh, st_c, ccfg,
                                          n_cycles)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    ms_c /= n_cycles
    log(f"[{tag}] {gpu_line} | hop_compact=4 frac={ccfg.hop_compact_frac} "
        f"brownian_rng={ccfg.brownian_rng} ms_per_cycle={ms_c:.4f} "
        f"host_enqueue_ms_per_cycle={host_c / n_cycles:.4f} "
        f"particle_steps_per_s={n / (ms_c * 1e-3):.4e} max_memory_allocated={peak} "
        f"launches={ {a: v for a, v in got.items() if v} }")
    pre = "convex_" if convex else ""
    need_launches(dev, got, {f"{pre}stream_crossers": n_cycles, "hop_admit": n_cycles,
                             f"{pre}stream_cycle": n_cycles, f"{pre}rare_resolve": n_cycles,
                             "pack_rows": 1, "unpack_rows": 1}, tag)
    domain_check(torch, cpt, cmesh, st_c, n_in, tag)

    # one more cycle's stages, and the compacted stream's time against plain
    if convex:
        tab = fused_convex.cx_table(cmesh)
        m0 = fused.pack_state(tab, st_c.pos, st_c.vel, st_c.tet_id, st_c.active,
                              fused_convex.WIDTH)
    else:
        tab = cmesh.tet_row
        m0 = fused.pack_state(tab, st_c.pos, st_c.vel, st_c.tet_id, st_c.active)
    xi = fused._brownian_noise(st_c.seed, st_c.step, n, m0.dtype, dev)
    flags_k, flags_p, apply_k, apply_p = compact_stages(
        fused, fused_convex, fused_cuda, convex, tab, xi,
        fused.stream_kwargs(ccfg, ccfg.dt, m0.dtype),
        ccfg.reflect_wall and ccfg.inline_bounce, ccfg.escape_faces)
    work = m0.clone()
    cr, ad, pk = (torch.empty(n, dtype=torch.uint8, device=dev) for _ in range(3))
    disp = torch.empty((n, 3), dtype=m0.dtype, device=dev)
    capb = fused.hop_capacity(n, ccfg.hop_compact_frac)

    def restore_c():
        work.copy_(m0)

    def compacted(flags, admit_fn, apply):
        def run():
            flags(work, cr)
            admit_fn(cr, ad, capb=capb)
            apply(work, pk, disp, ad)
        return run

    run_k = compacted(flags_k, fused_cuda.hop_admit, apply_k)
    run_p = compacted(flags_p, fused.hop_admit_plain, apply_p)
    restore_c()
    run_p()
    mp, pp, crp = work.clone(), pk.clone(), cr.clone()
    restore_c()
    run_k()
    same, err = compare(torch, work, mp, pk, pp)
    need(same and torch.equal(cr, crp) and err <= POS_TOL_F32,
         f"{tag}: compacted stream kernels != plain")
    groups = cr.view(-1, 4).sum(dim=1)
    n_cross, n_adm = int(cr.sum()), int(ad.sum())
    log(f"[{tag}] one more cycle: crossers={n_cross} ({n_cross / n:.4%}) pending_groups="
        f"{int((groups > 0).sum())} capb={capb} admitted={n_adm} overflow={n_cross - n_adm} "
        f"({(n_cross - n_adm) / n:.4%}) pending={int(pk.sum())} ({int(pk.sum()) / n:.4%}) "
        f"kernel_vs_plain identical={int(same)} max_abs_err={err:.3e}")
    key = f"{pre}stream"
    errs[key] = max(errs[key], err)
    t = kernel_vs_plain_ms(timer, run_k, run_p, restore_c)
    log(f"[{tag}] {gpu_line} | {pre}compacted_stream_ms={t[0]:.4f} ({t[2][1]:.4f}, "
        f"{t[2][2]:.4f}) plain_ms={t[1]:.4f} ({t[2][0]:.4f}, {t[2][3]:.4f}) lanes={n} "
        f"(flag pass + hop_admit + apply pass)")

    # each pass on its own, on the kernels' flags and admission
    restore_c()
    run_k()
    adk = ad.clone()
    hopped = moved(torch, m0, work) if convex else rows_changed(torch, m0, work, 20)
    shape = dict(n=n, elem=m0.element_size(), noise="xi")
    fn = "convex_stream" if convex else "stream"
    counts[f"{key}_crossers"] = (fn, dict(shape, pass_="crossers"))
    if convex:
        counts[f"{key}_admitted"] = (fn, dict(shape, pass_="admitted", row_loads=n_adm,
                                              hopped=hopped))
    else:
        counts[f"{key}_admitted"] = (fn, dict(shape, pass_="admitted", hops=hopped,
                                              hopped=hopped))
    times = {
        f"{key}_crossers": kernel_vs_plain_ms(timer, lambda: flags_k(work, cr),
                                              lambda: flags_p(work, cr), restore_c),
        f"{key}_admitted": kernel_vs_plain_ms(timer, lambda: apply_k(work, pk, disp, adk),
                                              lambda: apply_p(work, pk, disp, adk), restore_c)}
    for name, (t_k, t_p, parts) in times.items():
        log(f"[{tag}] {gpu_line} | {name}_kernel_ms={t_k:.4f} ({parts[1]:.4f}, {parts[2]:.4f}) "
            f"{name}_plain_ms={t_p:.4f} ({parts[0]:.4f}, {parts[3]:.4f}) lanes={n}")
    return times


def copy_ms(torch, dev, timer, nbytes, reps=20):
    """Mean ms of a device copy_ that moves ``nbytes`` (half read, half
    written): the bandwidth yardstick beside a kernel's bound."""
    src = torch.zeros(max(nbytes // 2, 1), dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    return time_calls(timer, lambda: dst.copy_(src), lambda: None, reps)


# bound by a launch's latency, not by bytes
SMALL = ("hop_admit", "rare", "convex_rare", "rare_pk", "rare_tutorial", "rare_rk4",
         "rare_pk_rk4", "rare_tjunction", "rare_dp", "rare_remote", "rare_pk_remote",
         "rare_tjunction_par")


def phase_bounds(torch, traffic, dev, counts, times, per_cycle, floor, gpu_line):
    """Phase 6: each timed kernel's bytes at this run's counts, its bound,
    the share bound / time, its launches per sub-step on its path, and the
    copy yardstick; for the kernels of a few megabytes also the launch
    floor and the share of max(bound, floor); returns them by timing key."""
    timer = Timer(torch, dev)
    out = {}
    for name, (fn, kw) in counts.items():
        t = getattr(traffic, fn)(**kw)
        ms = times[name][0]
        cp = copy_ms(torch, dev, timer, t.bytes)
        out[name] = dict(bytes=t.bytes, bound_ms=t.bound_ms, bound_by=t.bound_by,
                         share=t.bound_ms / ms, copy_ms=cp, launches_per_cycle=per_cycle[name])
        extra = " ".join(f"{k}={v}" for k, v in kw.items() if k not in ("n", "elem"))
        small = ""
        if name in SMALL:
            out[name].update(launch_floor_ms=floor,
                             share_of_floor=traffic.share_of_floor(t.bound_ms, floor, ms))
            small = (f" launch_floor_ms={floor:.5f} "
                     f"share_of_floor={out[name]['share_of_floor']:.3f}")
        log(f"[bound] {gpu_line} | {name} lanes={kw['n']} {extra} bytes={t.bytes} "
            f"(read {t.read}, written {t.written}) ops={t.ops} bound_ms={t.bound_ms:.4f} "
            f"({t.bound_by}) kernel_ms={ms:.4f} share={t.bound_ms / ms:.3f} "
            f"copy_ms={cp:.4f} launches_per_cycle={per_cycle[name]:.3f}{small}")
    return out


CHASE_STEPS = 4096   # dependent loads per chase_kernel launch
CHASE_REPS = 20      # launches in one reading (device_ms)


def chase_latency(torch, probe, timer, dev, tab, nbr):
    """(neighbour-walk ms, memory ms) per dependent load: chase_kernel's
    two chains, CHASE_STEPS loads a launch, CHASE_REPS launches replayed
    from a graph (device_ms).  The memory chain runs over a random
    single-cycle permutation of as many 4-byte entries as ``tab`` holds
    (the table's bytes, in float32).  On the CPU the host loops."""
    state = torch.tensor([0, 12345], dtype=torch.int32, device=dev)
    nbr_ms = device_ms(torch, timer, lambda: probe.chase_neighbours(tab, nbr, CHASE_STEPS, state),
                       reps=CHASE_REPS) / CHASE_STEPS
    nxt = probe.permutation(tab.numel(), 7, dev)
    pstate = torch.zeros(2, dtype=torch.int32, device=dev)
    mem_ms = device_ms(torch, timer, lambda: probe.chase_permutation(nxt, CHASE_STEPS, pstate),
                       reps=CHASE_REPS) / CHASE_STEPS
    del nxt
    return nbr_ms, mem_ms


def probe_parity(torch, probe, tab, nbr, dev):
    """chase_kernel against its host loop: 300 steps of each chain from
    the same state land on the same entry (the neighbour walk on ``tab``,
    the permutation over 100,003 entries)."""
    for name, run, data in (
        ("neighbour", lambda t, s: probe.chase_neighbours(t, nbr, 300, s), tab),
        ("permutation", lambda t, s: probe.chase_permutation(t, 300, s),
         probe.permutation(100_003, 3, dev)),
    ):
        sk = torch.tensor([5, 777], dtype=torch.int32, device=dev)
        sp = sk.cpu()
        run(data, sk)
        run(data.cpu(), sp)
        need(torch.equal(sk.cpu(), sp), f"chase_kernel ({name}) != its host loop")


def chain_stats(torch, chain):
    """(mean, p99, max) of a [n_pending] chain tensor; zeros when empty."""
    if chain.numel() == 0:
        return 0.0, 0.0, 0
    c = chain.double()
    return float(c.mean()), float(torch.quantile(c, 0.99)), int(chain.max())


def pending_first(torch, case):
    """The case's inputs with the lanes reordered so that every pending
    lane comes first (in lane order), and the order: the wave experiment,
    all pending lanes in the first blocks."""
    order = torch.argsort(case.p1.to(torch.int16), descending=True, stable=True)
    d = None if case.d1 is None else case.d1[order].contiguous()
    return case.m1[order].contiguous(), case.p1[order].contiguous(), d, order


def rare_call_ms(torch, timer, call, m_in, p_in, d_in):
    """Device ms of one rare call ``call(m, pend, disp)`` on copies of the
    inputs (device_ms with restore), and the state it leaves."""
    work, pend = m_in.clone(), p_in.clone()
    disp = None if d_in is None else d_in.clone()

    def restore():
        work.copy_(m_in)
        pend.copy_(p_in)

    ms = device_ms(torch, timer, lambda: call(work, pend, disp), restore)
    restore()
    call(work, pend, disp)
    return ms, work


def chain_sweep(torch, timer, case):
    """The case's call timed with only the lanes whose chain is at most c
    left pending, for each c of the run: (c, lanes, device ms) and the
    least-squares line through (c, ms), whose slope is what one more step
    of the longest chain costs and whose intercept is what a call costs
    besides its chain (launch, flag scan, the lane's own rows)."""
    idx = case.p1.nonzero()[:, 0]
    rows = []
    for c in sorted(set(case.chain.tolist())):
        p = torch.zeros_like(case.p1)
        p[idx[case.chain <= c]] = 1
        rows.append((c, int(p.sum()), rare_call_ms(torch, timer, case.run, case.m1, p,
                                                   case.d1)[0]))
    if len(rows) < 2:
        return rows, 0.0, rows[0][2] if rows else 0.0
    slope, intercept = np.polyfit([r[0] for r in rows], [r[2] for r in rows], 1)
    return rows, float(slope), float(intercept)


def phase_latency(torch, traffic, probe, fused, fused_cuda, dev, tab, rares, times, floor,
                  gpu_line):
    """Phase 6, the rare kernels' latency bound: the latency of one
    dependent load (chase_kernel: the neighbour walk on the slice's table
    and a random chain over as many bytes), and for each rare row the
    readings ``rares`` (a RareStudy) took in its slice phase: chain
    statistics (rare_chain on the slice's pending lanes), its time again
    and with the pending lanes moved into the first blocks (the same lanes,
    reordered; identical results), the sweep by longest chain; with them
    its latency bound and share of it.  Returns the keys each rare row adds
    to the kernel table."""
    timer = Timer(torch, dev)
    nbr = fused.LAYOUT_TET.nbr
    probe_parity(torch, probe, tab, nbr, dev)
    t_nbr, t_mem = chase_latency(torch, probe, timer, dev, tab, nbr)
    how = ("chase_kernel, one thread" if dev.type == "cuda"
           else "host loop (cpu rehearsal), not a device figure")
    log(f"[latency] {gpu_line} | dependent load: neighbour walk t_dep_ms={t_nbr:.3e} "
        f"({t_nbr * 1e6:.1f} ns; tet_row {tuple(tab.shape)}, codes at {nbr}:{nbr + 4}), "
        f"random chain over {tab.numel() * 4} B t_dep_hbm_ms={t_mem:.3e} ({t_mem * 1e6:.1f} ns); "
        f"{CHASE_STEPS} loads a launch, {CHASE_REPS} launches replayed from a graph; {how}")
    if dev.type == "cuda":
        # each instantiation's grid: min(ceil(n / 256), the blocks resident at once)
        for n in (rares.rows["rare"]["lanes"], 65_536):
            grids = []
            for tname, dt in (("float", torch.float32), ("double", torch.float64)):
                grids += [f"rare_kernel<{tname}>={fused_cuda.rare_grid(n, dt)}",
                          f"rare_kernel<{tname}, pk>={fused_cuda.rare_grid(n, dt, fused.LAYOUT_PK)}",
                          f"convex_rare_kernel<{tname}>={fused_cuda.convex_rare_grid(n, dt)}"]
            log(f"[latency] grid blocks at {n} lanes: {' '.join(grids)}")
    out = {}
    for name, r in rares.rows.items():
        bound = traffic.latency_bound(r["chain_max"], t_nbr, floor)
        ms = times[name][0]
        out[name] = dict(pending=r["pending"], chain_mean=r["chain_mean"],
                         chain_p99=r["chain_p99"], chain_max=r["chain_max"], t_dep_nbr_ms=t_nbr,
                         t_dep_hbm_ms=t_mem, latency_bound_ms=bound,
                         share_of_latency=traffic.share_of_latency(bound, ms),
                         one_call_at_a_time_ms=(times[name][2][1] + times[name][2][2]) / 2,
                         real_ms=r["real_ms"], pending_first_ms=r["pending_first_ms"],
                         ms_per_chain_step=r["ms_per_chain_step"],
                         ms_at_chain_0=r["ms_at_chain_0"])
        o = out[name]
        log(f"[latency] {gpu_line} | {name} lanes={r['lanes']} pending={o['pending']} "
            f"chain_mean={o['chain_mean']:.3f} chain_p99={o['chain_p99']:.1f} "
            f"chain_max={o['chain_max']} latency_bound_ms={bound:.5f} (launch floor "
            f"{floor:.5f} + (2 + {o['chain_max']}) x {t_nbr:.3e}) kernel_ms={ms:.5f} "
            f"share_of_latency={o['share_of_latency']:.3f} "
            f"one_call_at_a_time_ms={o['one_call_at_a_time_ms']:.4f} "
            f"again_ms={o['real_ms']:.5f} pending_first_ms={o['pending_first_ms']:.5f}")
        log(f"[latency] {gpu_line} | {name} by longest chain c (lanes with chain <= c "
            f"pending): " + " ".join(f"c={c}:{k}:{t:.5f}" for c, k, t in r["sweep"])
            + f" ms_per_chain_step={o['ms_per_chain_step']:.3e} "
            f"ms_at_chain_0={o['ms_at_chain_0']:.5f}")
    return out


def load_parent(_build, parent):
    """(the library built from the sources of the checkout ``parent``, this
    tree's library), for phase 7; logs the build and its rare kernels'
    ptxas lines."""
    import ctypes

    csrc = os.path.join(parent, "cudaparticlesfoam_tpu_torch", "csrc")
    t0 = time.perf_counter()
    plib = ctypes.CDLL(_build.build(csrc))
    log(f"[parent] {parent}: built from {len(_build.sources(csrc))} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(_build.ptxas_report(csrc)):
        if "rare" in line:
            log(f"[parent] {line}")
    return plib, _build.library()


def parent_ab(torch, timer, dev, name, case, plib, mine):
    """Phase 7's readings of one rare case: the parent's kernel and this
    tree's, through their bare C entries on the same inputs, in turns
    (parent, this, this, parent), on the real pending lanes and on the
    pending-first order (results identical), and the host's time to enqueue
    one call of each (no sync).  Returns {(tag, order): [ms, ms]} and
    {"enqueue": {tag: [ms, ms]}}."""
    fp, fm = getattr(plib, case.entry), getattr(mine, case.entry)
    fp.argtypes, fp.restype = fm.argtypes, fm.restype

    def call(f):
        return lambda m, p, d: need(case.c_call(f, m, p, d, torch.cuda.current_stream(
            dev).cuda_stream) == 0, f"{name} launch failed")

    first = pending_first(torch, case)[:3]
    res, kept = {}, {}
    for tag, f in (("parent", fp), ("this", fm), ("this", fm), ("parent", fp)):
        for order, ins in (("real", (case.m1, case.p1, case.d1)), ("first", first)):
            ms, w = rare_call_ms(torch, timer, call(f), *ins)
            res.setdefault((tag, order), []).append(ms)
            kept.setdefault((tag, order), w)
    for order in ("real", "first"):
        need(bitwise_equal(torch, kept[("parent", order)], kept[("this", order)]),
             f"{name}: this tree's kernel != the parent's ({order})")
    del kept, first
    work, pend = case.m1.clone(), case.p1.clone()
    enqueue = {}
    for tag, f in (("parent", fp), ("this", fm), ("this", fm), ("parent", fp)):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(BATCH):
            call(f)(work, pend, case.d1)
        enqueue.setdefault(tag, []).append((time.perf_counter() - h0) * 1e3 / BATCH)
        torch.cuda.synchronize()
    res["enqueue"] = enqueue
    return res


def phase_parent(traffic, rares, latency, gpu_line):
    """Phase 7 (``--parent DIR``, a checkout of another commit): its rare
    kernels against this tree's, from the readings ``parent_ab`` took in
    the slice phases, each share of the latency bound of phase 6.  The
    remote instantiations have no counterpart there and take no A/B."""
    for name, r in rares.rows.items():
        if r["parent"] is None:
            continue
        res = dict(r["parent"])
        enqueue = res.pop("enqueue")
        bound = latency[name]["latency_bound_ms"]
        mean = {key: sum(v) / len(v) for key, v in res.items()}
        share = {tag: traffic.share_of_latency(bound, mean[(tag, "real")])
                 for tag in ("parent", "this")}
        latency[name].update(parent_ms=mean[("parent", "real")],
                             parent_pending_first_ms=mean[("parent", "first")],
                             parent_share_of_latency=share["parent"],
                             parent_host_enqueue_ms=sum(enqueue["parent"]) / 2,
                             host_enqueue_ms=sum(enqueue["this"]) / 2)
        line = " ".join(f"{tag}_{order}_ms=({', '.join(f'{ms:.5f}' for ms in runs)})"
                        for (tag, order), runs in res.items())
        log(f"[parent] {gpu_line} | {name} {line} latency_bound_ms={bound:.5f} "
            f"share_of_latency parent={share['parent']:.3f} this={share['this']:.3f} "
            f"identical=1 host_enqueue_ms_per_call " + " ".join(
                f"{tag}=({', '.join(f'{x:.5f}' for x in v)})" for tag, v in enqueue.items()))


PITZ = os.path.join(HERE, "tutorials", "incompressible", "cudaParticlesUncoupledFoam",
                    "pitzDaily")
PITZ_NOISE = os.path.join(HERE, "tests", "golden", "torch_port_pitz_noise.npz")


def pitz_case(dst, particles=None, delta_t=None):
    """A copy of the repo's pitzDaily tutorial in ``dst`` with the
    synthetic converged field of tests/test_golden.py's driver anchor
    (u_x = 1 + 20 y at the cell centres, time 282, inside the particle
    window); ``particles`` / ``delta_t`` shrink its cudaParticlesDict /
    controlDict as that test does (None keeps the tutorial's own)."""
    import shutil

    from cudaparticlesfoam_tpu_torch.io import blockmesh, foamfile, polymesh

    case = os.path.join(dst, "pitzDaily")
    shutil.copytree(PITZ, case)
    for name, key, value in (("cudaParticlesDict", "numParticles", particles),
                             ("controlDict", "deltaT", delta_t)):
        if value is None:
            continue
        path = os.path.join(case, "system", name)
        d = foamfile.read(path)
        d.pop("FoamFile", None)
        d.pop("functions", None)
        d[key] = value
        foamfile.write(path, d, obj_name=name)
    pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
    ctrs, _ = polymesh.cell_centres_volumes(pm)
    u = np.zeros((pm.n_cells, 3))
    u[:, 0] = 1.0 + 20.0 * ctrs[:, 1]
    os.makedirs(os.path.join(case, "282"))
    polymesh.write_field(os.path.join(case, "282", "U"), "U", u)
    return case


def phase_driver_anchor(torch, fused, fused_cuda, dev, tmp, gpu_line):
    """Phase 8a: the pitzDaily driver anchor (tests/test_golden.py) through
    uncoupled.run in float64 on ``dev``, the JAX run's Brownian normals
    replayed from tests/golden/torch_port_pitz_noise.npz; gated on the
    base-point builder as the test is."""
    from cudaparticlesfoam_tpu_torch.models import case as caselib
    from cudaparticlesfoam_tpu_torch.models import uncoupled

    g = np.load(GOLDEN)
    want = str(g["builder_flavor"])
    if caselib._builder_flavor() != want:
        log(f"[driver-anchor] skipped: the anchor was built with the {want} base-point "
            f"builder, this host has {caselib._builder_flavor()} (no g++)")
        return
    noise = torch.as_tensor(np.load(PITZ_NOISE)["noise"], device=dev)
    case_dir = pitz_case(tmp, particles=200, delta_t=0.01)
    draw = fused._brownian_noise
    fused._brownian_noise = lambda seed, step, n, dtype, device, mode="threefry": noise[step]
    try:
        for name in COUNTED:
            getattr(fused_cuda, name).launches = 0
        t0 = time.perf_counter()
        _, st, stats = uncoupled.run(case_dir, write_output=False, dtype=np.float64,
                                     device=dev, log=lambda *a: None)
        secs = time.perf_counter() - t0
        got = {name: getattr(fused_cuda, name).launches for name in COUNTED}
    finally:
        fused._brownian_noise = draw
    err = float(np.abs(st.pos.cpu().numpy() - g["pitz_pos"]).max())
    tet_ok = bool((st.tet_id.cpu().numpy() == g["pitz_tet"]).all())
    act_ok = bool((st.active.cpu().numpy() == g["pitz_active"]).all())
    ran = {k: v for k, v in got.items() if v}
    log(f"[driver-anchor] {gpu_line} | pitzDaily shear, 200 particles, f64, builder={want}: "
        f"cycles={stats['cycles']} max_abs_err={err:.3e} tet_exact={int(tet_ok)} "
        f"active_exact={int(act_ok)} launches={ran} run_s={secs:.2f}")
    need(stats["cycles"] == 100 and tet_ok and act_ok and err <= POS_TOL_GOLDEN,
         "the pitzDaily driver anchor failed")
    # one pack and one unpack a run_cycles call: 20 calls of 5 cycles
    need_launches(dev, got, {"stream_cycle": 100, "rare_resolve": 100, "pack_rows": 20,
                             "unpack_rows": 20}, "driver anchor")


def _frame_summary(path):
    """(points, DataArray names) of a VTU frame: it parses as XML."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    return (int(next(root.iter("Piece")).get("NumberOfPoints")),
            [da.get("Name") for da in root.iter("DataArray")])


TUTORIAL_PATH = "uncoupled driver, pitzDaily tutorial (1e5 particles, 1000 cycles)"
FRAME_ARRAYS = ["Position", "ParticleType", "ParticleID", "ParticleTetID", "vels", "KEs",
                "connectivity", "offsets", "types"]


def phase_driver_tutorial(torch, dev, tmp, rehearse, gpu_line):
    """Phase 8b: the tutorial at its own settings through the CLI in a
    subprocess (``python -m cudaparticlesfoam_tpu_torch uncoupled``), on
    the card in float32: 1e5 particles, dt 1e-4, deltaT 0.1 (1000 cycles),
    saveInterval 10 (101 frames); the rehearsal shrinks it to 2,000
    particles and deltaT 0.01 on the CPU.  Returns (case dir, launches,
    the run's numbers)."""
    shrink = dict(particles=2_000, delta_t=0.01) if rehearse else {}
    case_dir = pitz_case(tmp, **shrink)
    return (case_dir,) + tutorial_cli_run(torch, dev, case_dir, os.path.join(tmp, "frames"),
                                          rehearse, gpu_line, "driver-tutorial",
                                          "pitzDaily tutorial via the CLI")


def cli(args, timeout=900):
    """``python -m cudaparticlesfoam_tpu_torch *args`` in a subprocess from
    the repo's root: (completed process, seconds)."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cudaparticlesfoam_tpu_torch", *args], cwd=HERE,
                         env=env, capture_output=True, text=True, timeout=timeout)
    return res, time.perf_counter() - t0


def tutorial_cli_run(torch, dev, case_dir, out, rehearse, gpu_line, tag, label, extra=None):
    """``uncoupled`` through the CLI on ``case_dir`` and the frame checks of
    phase 8b: every frame parses, in the last every lane active with a tet
    >= 0, inside the pitzDaily bounds, KEs all zeros, no lane out of the
    domain; on the card one stream and one rare launch a cycle.  Logs one
    line (``extra(numbers)`` appended); returns (launches, numbers)."""
    import concurrent.futures as cf
    import xml.etree.ElementTree as ET

    cmd = ["uncoupled", case_dir, "--out", out] + (["--device", "cpu"] if rehearse else [])
    res, secs = cli(cmd)
    need(res.returncode == 0, f"the CLI tutorial run failed: {res.stderr[-3000:]}")
    text = res.stdout
    n_cycles = int(re.search(r"nCycles: (\d+)", text).group(1))
    n_part = 2_000 if rehearse else 100_000
    phases = {m.group(1): [float(x) for x in m.group(2).split("\t") if x]
              for m in re.finditer(r"^\t(Init|Seed|Advect|IO)\t([\d.\t]+)$", text, re.M)}
    runtime = re.search(r"Simulation RunTime=([\d.]+) ms \(([\d.]+)M particle-steps/s\)", text)
    ood = [int(x) for x in re.findall(r"Out-of-domain particles\(-tetID\) = (\d+)", text)]

    frames = sorted(f for f in os.listdir(out) if f.endswith(".vtu"))
    t1 = time.perf_counter()
    with cf.ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        summaries = list(ex.map(_frame_summary, [os.path.join(out, f) for f in frames]))
    parse_s = time.perf_counter() - t1
    need(len(frames) == len(range(0, n_cycles, 10)) + 1 and frames[0] == "particle_0000.vtu",
         f"{len(frames)} frames for {n_cycles} cycles")
    need(all(s == (n_part, FRAME_ARRAYS) for s in summaries), "a frame does not parse")

    def frame_arrays(name):
        root = ET.parse(os.path.join(out, name)).getroot()
        return {da.get("Name"): np.array(da.text.split(), dtype=float)
                for da in root.iter("DataArray")}

    arrays = frame_arrays(frames[-1])
    pos = arrays["Position"].reshape(-1, 3)
    tet, act = arrays["ParticleTetID"], arrays["ParticleType"] > 0
    bounds = (np.array([-0.0206, -0.0254, -0.0005]), np.array([0.29, 0.0254, 0.0005]))
    inside = bool(((pos[act] >= bounds[0] - 1e-6) & (pos[act] <= bounds[1] + 1e-6)).all())
    out_of_domain = int((tet < 0).sum())
    frames_mb = sum(os.path.getsize(os.path.join(out, f)) for f in frames) / 1e6
    # the phase table: device span first, the host's time last on the card
    host_s = {k: v[-1] if dev.type == "cuda" else v[0] for k, v in phases.items()}
    dev_line = re.search(r"#adv: on (.*): Advect ([\d.]+) ms/cycle on the device, ([\d.]+) "
                         r"ms/cycle to issue; kernel launches (\{.*\}); peak device memory "
                         r"([\d.]+) GiB", text)
    if dev_line:     # the same spans to 4 decimals
        adv_ms, issue_ms = float(dev_line.group(2)), float(dev_line.group(3))
    else:
        adv_ms, issue_ms = (phases["Advect"][0] / n_cycles * 1e3,
                            host_s["Advect"] / n_cycles * 1e3)
    line = (f"[{tag}] {gpu_line} | {label}: particles={n_part} "
            f"cycles={n_cycles} frames={len(frames)} ({frames_mb:.0f} MB, parsed in "
            f"{parse_s:.1f} s) active={int(act.sum())} active_tet_ge_0="
            f"{int((tet[act] >= 0).all())} inside_bounds={int(inside)} "
            f"out_of_domain={out_of_domain} seeding_out_of_domain={ood} "
            f"KEs_zero={int((arrays['KEs'] == 0).all())} "
            f"phases_s={ {k: v[0] for k, v in phases.items()} } host_phases_s={host_s} "
            f"advect_ms_per_cycle={adv_ms:.4f} host_issue_ms_per_cycle={issue_ms:.4f} "
            f"advect_particle_steps_per_s={n_part / max(adv_ms * 1e-3, 1e-12):.4e} "
            f"runtime_ms={runtime.group(1)} ({runtime.group(2)}M particle-steps/s, frames "
            f"included) command_s={secs:.1f}")
    launches = {}
    if dev_line:
        launches = json.loads(dev_line.group(4).replace("'", '"'))
        line += (f" peak_device_GiB={dev_line.group(5)} launches={launches} "
                 f"stream_per_cycle={launches.get('stream_cycle', 0) / n_cycles:.3f} "
                 f"rare_per_cycle={launches.get('rare_resolve', 0) / n_cycles:.3f}")
    # the mean x of the active lanes, first written cycle against the last
    first = frame_arrays(frames[1])
    info = {"adv_ms": adv_ms, "issue_ms": issue_ms, "cycles": n_cycles, "command_s": secs,
            "mean_x": (float(first["Position"].reshape(-1, 3)[first["ParticleType"] > 0,
                                                                0].mean()),
                       float(pos[act, 0].mean()))}
    log(line + (extra(info) if extra else ""))
    need(act.all() and (tet[act] >= 0).all() and inside and out_of_domain == 0
         and ood == [0] and (arrays["KEs"] == 0).all() and np.isfinite(pos).all(),
         f"the {label} run left the domain or broke the frame contract")
    if dev.type == "cuda":
        need(dev_line is not None, "the CLI run printed no device line")
        need(launches == {"stream_cycle": n_cycles, "rare_resolve": n_cycles},
             f"the {label} run launched {launches}, not one stream and one rare kernel "
             f"a cycle")
    return launches, info


def phase_driver_cycle(torch, cpt, fused, fused_cuda, dev, case_dir, warm, errs, counts, rares,
                       gpu_line):
    """Phase 8c: one cycle at 8b's shape (its mesh, seeds and tuning, with
    inline_bounce=True, after ``warm`` cycles), stream_kernel and
    rare_kernel against their plain versions, and each kernel's time at
    this shape (device_ms) for phase 6's bounds.  Returns the times."""
    from cudaparticlesfoam_tpu_torch.models import case as caselib

    case = caselib.load_case(case_dir, log=lambda *a: None, device=dev)
    st = caselib.init_particles(case, log=lambda *a: None)
    cfg = cpt.suggest_tuning(case.tet_mesh, case.particles.step_config(),
                             n_particles=st.n_particles)
    need(cfg.inline_bounce and cfg.inline_hops == 1,
         f"the tutorial's tuning is inline_hops={cfg.inline_hops} inline_bounce="
         f"{cfg.inline_bounce}, not 1 and True")
    mesh, n = case.tet_mesh, st.n_particles
    n_cycles, dt = cpt.n_cycles_for(case.control.delta_t, case.particles.dt)
    st = cpt.run_cycles(mesh, st, cfg, warm, dt)
    timer = Timer(torch, dev)

    # the driver's loop, warm, in process: 100 cycles in the chunks it runs
    # between two frames (1, then saveInterval - 1), and as one run_cycles
    # call; the device's ms per cycle (events) and the host's time to issue
    every = case.particles.save_interval
    for name, chunks in (("chunks", [1, every - 1] * (100 // every)), ("one_call", [100])):
        s = cpt.run_cycles(mesh, st, cfg, chunks[0], dt)          # warm-up
        timer.start()
        h0 = time.perf_counter()
        for c in chunks:
            s = cpt.run_cycles(mesh, s, cfg, c, dt)
        host_ms = (time.perf_counter() - h0) * 1e3 / sum(chunks)
        ms = timer.stop() / sum(chunks)
        log(f"[driver-cycle] {gpu_line} | warm run_cycles loop, {name} {chunks[:2]}...: "
            f"ms_per_cycle={ms:.4f} host_issue_ms_per_cycle={host_ms:.4f} lanes={n}")
    # one frame: the copy off the card and the native writer, on the host clock
    from cudaparticlesfoam_tpu_torch.io import vtu

    h0 = time.perf_counter()
    held = vtu.AsyncVTUWriter()
    held.write(0, s, out_dir=os.path.join(os.path.dirname(case_dir), "frame"))
    copy_s = time.perf_counter() - h0
    held.close()
    log(f"[driver-cycle] {gpu_line} | one frame of {n} lanes: copy off the card "
        f"{copy_s * 1e3:.2f} ms, copy + write {(time.perf_counter() - h0):.3f} s")
    m0 = fused.pack_state(fused.row_table(mesh), st.pos, st.vel, st.tet_id, st.active)
    xi = fused._brownian_noise(st.seed, st.step, n, m0.dtype, dev)
    sa = stream_args(cfg, dt, m0.dtype, fused)
    ra = rare_args(cfg)
    mk, mp = m0.clone(), m0.clone()
    pk = torch.empty(n, dtype=torch.uint8, device=dev)
    pp = torch.empty_like(pk)
    fused_cuda.stream_cycle(mesh.tet_row, mk, xi, pk, **sa)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **sa)
    same_s, err_s = compare(torch, mk, mp, pk, pp)
    m1, p1 = mp.clone(), pp.clone()
    hops = rows_changed(torch, m0, mk, 20)
    fused_cuda.rare_resolve(mesh.tet_row, mk, pk, mesh.bd_escape, **ra)
    fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **ra)
    same, err = compare(torch, mk, mp)
    pending = int(p1.sum())
    n_el = m0.element_size()
    counts["stream_tutorial"] = ("stream", dict(n=n, elem=n_el, noise="xi", hops=hops,
                                                hopped=hops))
    counts["rare_tutorial"] = ("rare", dict(n=n, elem=n_el, pending=pending,
                                            moved=moved(torch, m1, mk)))
    log(f"[driver-cycle] tutorial shape: lanes={n} tets={mesh.n_tets} after {warm} of "
        f"{n_cycles} cycles, inline_hops={cfg.inline_hops} inline_bounce={int(cfg.inline_bounce)}: "
        f"hop_share={hops / n:.4f} pending={pending} pending_share={pending / n:.4f} "
        f"stream_identical={int(same_s)} stream_max_abs_err={err_s:.3e} "
        f"cycle_identical={int(same)} cycle_max_abs_err={err:.3e}")
    need(same_s and same and max(err, err_s) <= POS_TOL_F32,
         "the tutorial cycle: kernel != plain")
    errs["stream_tutorial"], errs["rare_tutorial"] = err_s, err

    work, pend = m0.clone(), pk.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)

    times = {}
    for key, fn, plain, restore in (
        ("stream_tutorial", lambda: fused_cuda.stream_cycle(mesh.tet_row, work, xi, pend, **sa),
         lambda: fused.stream_plain(mesh.tet_row, work, xi, pend, **sa), restore_stream),
        ("rare_tutorial",
         lambda: fused_cuda.rare_resolve(mesh.tet_row, work, pend, mesh.bd_escape, **ra),
         lambda: fused.rare_plain(mesh.tet_row, work, pend, mesh.bd_escape, **ra),
         restore_rare),
    ):
        times[key] = rare_row(torch, timer, fn, plain, restore)
        t = times[key]
        log(f"[driver-cycle] {gpu_line} | {key}_kernel_ms={t[0]:.5f} (device: {BATCH} calls "
            f"replayed from a graph, restore subtracted) one_call_at_a_time_ms=({t[2][1]:.4f}, "
            f"{t[2][2]:.4f}) {key}_plain_ms={t[1]:.4f} ({t[2][0]:.4f}, {t[2][3]:.4f}) lanes={n}")
    rares.add("rare_tutorial", bary_rare_case(torch, fused, fused_cuda, mesh.tet_row, mesh, m1,
                                              p1, ra, fused.LAYOUT_TET, "cpf_rare_f32"))
    return times


def phase_rk4_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs):
    """Phase 9a: the RK4 instantiations of stream_kernel against stream_plain
    with rk4, bit for bit, then rare_kernel after them: float32 and float64
    x TET and PK x inline_hops {1, 3} x escape faces {off, on} x noise {xi,
    Philox} x 65,536 and 65,499 lanes, on the swirl box (stage points that
    stay, walk, and leave the domain)."""
    before = (fused_cuda.stream_cycle.rk4_launches, fused_cuda.rare_resolve.launches)
    cases = 0
    for dtype in (torch.float32, torch.float64):
        npdt = np.float32 if dtype == torch.float32 else np.float64
        base = convert.to_mesh(box_payload(tmesh, nside, npdt, swirl(nside)), dev)
        pos, vel, tet, act, xi = parity_lanes(torch, cpt, base, dev, nside, n, seed=12,
                                              dtype=dtype)
        tname = str(dtype).replace("torch.", "")
        for lname, hops, esc in itertools.product(("tet", "pk"), (1, 3), (False, True)):
            ly = fused.LAYOUT_PK if lname == "pk" else fused.LAYOUT_TET
            dt = 0.3 if hops == 1 else 0.9
            mesh = tmesh.set_boundary_escape(base, [1] if esc else [])
            mesh = cpt.with_pk_rows(mesh) if lname == "pk" else mesh
            tab = fused.row_table(mesh, ly)
            cfg = cpt.StepConfig(dt=dt, diffusion_coeff=5e-3, inline_hops=hops,
                                 escape_faces=esc, integrator="rk4",
                                 velocity_interp="VertexVelocity" if lname == "pk"
                                 else "TetVelocity")
            sa = dict(stream_args(cfg, dt, dtype, fused), ly=ly)
            ra = dict(rare_args(cfg), ly=ly)
            for philox, nn in itertools.product((False, True), (n, n - RAGGED)):
                m0 = fused.pack_state(fused.row_table(mesh, ly), pos[:nn], vel[:nn], tet[:nn],
                                      act[:nn], ly.width)
                key = fused.philox_key(13, hops) if philox else None
                xi_p = fused.philox_normals(key, nn, dtype, dev) if philox else xi[:nn]
                mk, mp = m0.clone(), m0.clone()
                pk = torch.empty(nn, dtype=torch.uint8, device=dev)
                pp = torch.empty_like(pk)
                walks = torch.zeros((3, 3), dtype=torch.int64, device=dev)
                fused_cuda.stream_cycle(tab, mk, None if philox else xi[:nn], pk,
                                        noise_key=key, rk4=True, **sa)
                fused.stream_plain(tab, mp, xi_p, pp, rk4=True, stage_walks=walks, **sa)
                same_s = bitwise_equal(torch, mk, mp) and bool(torch.equal(pk, pp))
                _, err_s = compare(torch, mk, mp)
                rk, rp = mp.clone(), mp.clone()
                fused_cuda.rare_resolve(tab, rk, pp, mesh.bd_escape, **ra)
                fused.rare_plain(tab, rp, pp, mesh.bd_escape, **ra)
                same_r = bitwise_equal(torch, rk, rp)
                cases += 1
                w = walks.cpu().tolist()
                case = (f"{tname} {lname} lanes={nn} hops={hops} esc={esc} "
                        f"noise={'philox' if philox else 'xi'}")
                log(f"[rk4-parity] {case} pending={int(pp.sum())} "
                    f"stage_walkers={[s[0] for s in w]} stage_rows={[s[1] for s in w]} "
                    f"stage_left_domain={[s[2] for s in w]} stream_identical={int(same_s)} "
                    f"stream_max_abs_err={err_s:.3e} rare_identical={int(same_r)}")
                need(all(s[0] > 0 and s[1] > 0 for s in w) and sum(s[2] for s in w) > 0,
                     f"rk4 parity case walks no stage, or none leaves the domain ({case})")
                need(same_s, f"stream_kernel<rk4> != stream_plain(rk4) ({case})")
                need(same_r, f"rare_kernel after rk4 != rare_plain ({case})")
                if dtype == torch.float32:
                    errs["stream_rk4"] = max(errs.get("stream_rk4", 0.0), err_s)
    if dev.type == "cuda":
        got = (fused_cuda.stream_cycle.rk4_launches - before[0],
               fused_cuda.rare_resolve.launches - before[1])
        need(got == (cases, cases), f"phase 9a launched {got}, not {(cases, cases)}")


def phase_rk4_simple(torch, cpt, fused_cuda, tmesh, convert, dev, nside, n, n_cycles, gpu_line):
    """Phase 9b: cached RK4 (the kernels) against the simple engine's RK4
    (torch ops) on one injected noise stream, float64, TetVelocity and
    VertexVelocity, every wall reflecting (as in phase 5d's [simple])."""
    payload = box_payload(tmesh, nside, np.float64, swirl(nside))
    mesh = cpt.with_pk_rows(convert.to_mesh(payload, dev))
    pos, vel, tet, act, _ = parity_lanes(torch, cpt, mesh, dev, nside, n, seed=14,
                                         dtype=torch.float64)
    st = dataclasses.replace(convert.to_state(pos.cpu().numpy(), tet.cpu().numpy(),
                                              dtype=np.float64, device=dev), vel=vel, active=act)
    noise = torch.as_tensor(np.random.default_rng(15).standard_normal((n_cycles, n, 3)),
                            dtype=torch.float64, device=dev)
    for vi in ("TetVelocity", "VertexVelocity"):
        cfg = cpt.StepConfig(dt=0.2, diffusion_coeff=5e-3, inline_hops=2, velocity_interp=vi,
                             integrator="rk4")
        before = (fused_cuda.stream_cycle.rk4_launches, fused_cuda.rare_resolve.launches)
        cached = cpt.run_cycles(mesh, st, cfg, n_cycles, noise=noise)
        ran = (fused_cuda.stream_cycle.rk4_launches - before[0],
               fused_cuda.rare_resolve.launches - before[1])
        simple = cpt.run_cycles(mesh, st, dataclasses.replace(cfg, engine="simple"), n_cycles,
                                noise=noise)
        same = bool(torch.equal(cached.tet_id, simple.tet_id)
                    and torch.equal(cached.active, simple.active))
        err = max(float((cached.pos - simple.pos).abs().max()),
                  float((cached.vel - simple.vel).abs().max()))
        hopped = int((simple.tet_id != tet).sum())
        log(f"[rk4-simple] {gpu_line} | float64 {vi} lanes={n} cycles={n_cycles} "
            f"lanes_in_a_new_tet={hopped} cached_equals_simple={int(same)} "
            f"max_abs_err={err:.3e} cached_launches={ran}")
        need(same and err <= POS_TOL_F64, f"cached RK4 != simple RK4 ({vi})")
        need(hopped > 0, f"the RK4 runs moved no lane across a face ({vi})")
        if dev.type == "cuda":
            need(ran == (n_cycles, n_cycles), f"cached RK4 launched {ran} ({vi})")


DUCT_CYCLES = 25     # tests/test_duct.py: k = 25 steps of ~0.01 cm at the centreline
DUCT_LANES = 4000    # and its lanes (its tolerances are tied to the 16 x 16 section)
RK4_PATH = "rk4-tracers cell (north-star slice, RK4, no Brownian term)"


def phase_duct(torch, cpt, fused_cuda, dev, n, gpu_line):
    """Phase 9c: the analytic square-duct oracle (tests/test_duct.py:70-140)
    through the cached engine's kernels, float32 and float64, Euler and
    RK4: 16 x 16 x 4 cells, the profile at the vertices, ``n`` lanes in
    the inner 80% of the section; the displacement against the exact
    k dt vz(x0, y0) within the test's bounds (max 0.02, median 0.006 of
    k dt vmax), x and y untouched."""
    from cudaparticlesfoam_tpu_torch.models import duct as mduct
    from cudaparticlesfoam_tpu_torch.ops import duct

    h = duct.TUBE_H
    rng = np.random.default_rng(11)
    pos0 = np.stack([rng.uniform(-0.4 * h, 0.4 * h, n), rng.uniform(0.1 * h, 0.9 * h, n),
                     rng.uniform(0.05, 0.1, n)], axis=1)
    vmax = float(duct.square_duct_velocity(np.array([0.0]), np.array([h / 2]))[0])
    dt, k = 0.01 / vmax, DUCT_CYCLES
    dz_exact = k * dt * duct.square_duct_velocity(pos0[:, 0], pos0[:, 1])
    for dtype in (torch.float32, torch.float64):
        mesh = mduct.duct_mesh(dtype=dtype, device=dev)
        st = cpt.make_state(pos0, dtype=dtype, device=dev)
        st = dataclasses.replace(st, tet_id=cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh),
                                                             st.pos))
        need(int((st.tet_id < 0).sum()) == 0, "a duct seed is outside the mesh")
        for integ in ("euler", "rk4"):
            cfg = cpt.StepConfig(dt=dt, use_brownian=False, velocity_interp="VertexVelocity",
                                 integrator=integ)
            before = (fused_cuda.stream_cycle.rk4_launches, fused_cuda.stream_cycle.launches)
            out = cpt.run_cycles(mesh, st, cfg, k)
            ran = (fused_cuda.stream_cycle.rk4_launches - before[0],
                   fused_cuda.stream_cycle.launches - before[1])
            pos = out.pos.double().cpu().numpy()
            rel = np.abs(pos[:, 2] - pos0[:, 2] - dz_exact) / (k * dt * vmax)
            dxy = float(np.abs(pos[:, :2] - st.pos.double().cpu().numpy()[:, :2]).max())
            tname = str(dtype).replace("torch.", "")
            log(f"[duct] {gpu_line} | {tname} {integ} lanes={n} cycles={k} "
                f"rel_err_max={rel.max():.4e} rel_err_median={np.median(rel):.4e} "
                f"xy_drift={dxy:.3e} out_of_domain={int((out.tet_id < 0).sum())} "
                f"launches={ran}")
            need(int((out.tet_id < 0).sum()) == 0, f"duct lanes left the mesh ({tname} {integ})")
            need(rel.max() < 0.02 and np.median(rel) < 0.006 and dxy <= 1e-7,
                 f"duct oracle bounds not held ({tname} {integ})")
            if dev.type == "cuda":
                want = (k if integ == "rk4" else 0, k)
                need(ran == want, f"duct run launched {ran}, not {want} ({tname} {integ})")


def phase_rk4_slice(torch, cpt, fused, fused_cuda, tmesh, dev, nside, slice_setup, n_cycles,
                    errs, counts, rares, gpu_line):
    """Phase 9d: the rk4-tracers cell (bench.py's rk4-tracers: RK4 with wall
    rebound, no Brownian term) at the north-star size, phase 5's mesh and
    seeds, TetVelocity and VertexVelocity (the vortex at the vertices):
    10 warm-up + ``n_cycles`` timed cycles through run_cycles with every
    launch count set to 0 just before, the domain checks, peak memory and
    the host's issue time; one more cycle kernel against plain (bit for
    bit) with the stage walks of each stage and the hop and pending
    shares; stream_kernel<rk4>'s time against its plain version and
    rare_kernel's device time at this shape."""
    mesh0, st0, n_in, _ = slice_setup
    n = st0.n_particles
    pts, _, _ = tmesh.box_points_tets(nside, nside, nside)
    launches, times = {}, {}
    timer = Timer(torch, dev)
    for lname in ("tet", "pk"):
        ly = fused.LAYOUT_PK if lname == "pk" else fused.LAYOUT_TET
        vi = "VertexVelocity" if lname == "pk" else "TetVelocity"
        mesh = (cpt.with_pk_rows(cpt.replace_velocity(mesh0, vert_vel=vortex(nside)(pts)))
                if lname == "pk" else mesh0)
        tab = fused.row_table(mesh, ly)
        cfg = cpt.suggest_tuning(mesh, cpt.StepConfig(dt=0.05, use_brownian=False,
                                                      integrator="rk4", velocity_interp=vi),
                                 n_particles=n)
        skey, rkey = ("stream_pk_rk4", "rare_pk_rk4") if lname == "pk" else ("stream_rk4",
                                                                             "rare_rk4")
        st = cpt.run_cycles(mesh, st0, cfg, 10)            # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fused_cuda.stream_cycle.rk4_launches = 0
        st, ms, host_ms, got = counted_run(torch, cpt, fused_cuda, timer, mesh, st, cfg, n_cycles)
        launches[skey] = fused_cuda.stream_cycle.rk4_launches
        launches[rkey] = got["rare_resolve"]
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        log(f"[rk4-slice] {gpu_line} | {vi} tets={mesh.n_tets} particles={n} "
            f"inline_hops={cfg.inline_hops} inline_bounce={int(cfg.inline_bounce)} "
            f"ms_per_cycle={ms / n_cycles:.4f} "
            f"particle_steps_per_s={n / (ms / n_cycles * 1e-3):.4e} "
            f"host_issue_ms_per_cycle={host_ms / n_cycles:.4f} max_memory_allocated={peak} "
            f"launches={ {k: v for k, v in got.items() if v} } rk4_launches={launches[skey]}")
        need_launches(dev, got, {"stream_cycle": n_cycles, "rare_resolve": n_cycles,
                                 "pack_rows": 1, "unpack_rows": 1}, f"rk4 slice ({vi})")
        if dev.type == "cuda":
            need(launches[skey] == n_cycles, f"rk4 slice ran {launches[skey]} RK4 launches")
        domain_check(torch, cpt, mesh, st, n_in, "rk4-slice")

        # one more cycle through kernel and plain, with the plain's stage walks
        m0 = fused.pack_state(fused.row_table(mesh, ly), st.pos, st.vel, st.tet_id, st.active,
                              ly.width)
        sa = dict(stream_args(cfg, cfg.dt, m0.dtype, fused), ly=ly, rk4=True)
        ra = dict(rare_args(cfg), ly=ly)
        mk, mp = m0.clone(), m0.clone()
        pk = torch.empty(n, dtype=torch.uint8, device=dev)
        pp = torch.empty_like(pk)
        walks = torch.zeros((3, 3), dtype=torch.int64, device=dev)
        fused_cuda.stream_cycle(tab, mk, None, pk, **sa)
        fused.stream_plain(tab, mp, None, pp, stage_walks=walks, **sa)
        same_s = bitwise_equal(torch, mk, mp) and bool(torch.equal(pk, pp))
        m1, p1 = mp.clone(), pp.clone()
        hk = rows_changed(torch, m0, mk, ly.tab_w)
        w = walks.cpu().tolist()
        counts[skey] = ("stream", dict(n=n, elem=m0.element_size(), noise="none", hops=hk,
                                       hopped=hk, layout=lname, rk4=True,
                                       stage_rows=sum(s[1] for s in w)))
        fused_cuda.rare_resolve(tab, mk, pk, mesh.bd_escape, **ra)
        counts[rkey] = ("rare", dict(n=n, elem=m0.element_size(), pending=int(p1.sum()),
                                     moved=moved(torch, m1, mk), layout=lname))
        fused.rare_plain(tab, mp, pp, mesh.bd_escape, **ra)
        same = bitwise_equal(torch, mk, mp)
        log(f"[rk4-slice] {vi} extra cycle kernel vs plain: stage_walkers={[s[0] for s in w]} "
            f"stage_walk_share={['%.4f' % (s[0] / n) for s in w]} "
            f"stage_rows={[s[1] for s in w]} stage_left_domain={[s[2] for s in w]} "
            f"hop_share={hk / n:.4%} pending={int(p1.sum())} "
            f"pending_share={int(p1.sum()) / n:.4%} stream_identical={int(same_s)} "
            f"cycle_identical={int(same)}")
        need(same_s and same, f"rk4 slice extra cycle kernel != plain ({vi})")
        errs[skey] = errs[rkey] = 0.0

        work, pend = m0.clone(), pk.clone()

        def restore_stream():
            work.copy_(m0)

        def restore_rare():
            work.copy_(m1)
            pend.copy_(p1)

        k_ms, p_ms, (p_a, k_a, k_b, p_b) = kernel_vs_plain_ms(
            timer, lambda: fused_cuda.stream_cycle(tab, work, None, pend, **sa),
            lambda: fused.stream_plain(tab, work, None, pend, **sa), restore_stream)
        times[skey] = (k_ms, p_ms)
        times[rkey] = rare_row(
            torch, timer, lambda: fused_cuda.rare_resolve(tab, work, pend, mesh.bd_escape, **ra),
            lambda: fused.rare_plain(tab, work, pend, mesh.bd_escape, **ra), restore_rare)
        t = times[rkey]
        log(f"[rk4-slice] {gpu_line} | {skey}_kernel_ms={k_ms:.4f} ({k_a:.4f}, {k_b:.4f}) "
            f"{skey}_plain_ms={p_ms:.4f} ({p_a:.4f}, {p_b:.4f}) {rkey}_kernel_ms={t[0]:.5f} "
            f"(device: {BATCH} calls replayed from a graph, restore subtracted) "
            f"{rkey}_plain_ms={t[1]:.4f} lanes={n}")
        rares.add(rkey, bary_rare_case(torch, fused, fused_cuda, tab, mesh, m1, p1,
                                       rare_args(cfg), ly,
                                       "cpf_rare_pk_f32" if lname == "pk" else "cpf_rare_f32"))
        # the next layout's peak memory holds phase 5's mesh and seeds, not these
        del st, m0, mk, mp, m1, p1, pk, pp, work, pend, mesh, tab
    return launches, times


# ptxas's lines (ptxas_lines) of every kernel of the library before the RK4
# instantiations existed, built by nvcc PINNED_NVCC on an H100 machine: the
# tree without them and this one, in one call.  The instantiations that were
# there must come out of this build unchanged.
PINNED_NVCC = "release 12.9, V12.9.86"
PINNED_PTXAS = (
    "chase_kernel<0>: 26 regs, 0 B stack, 0 B spill",
    "chase_kernel<1>: 24 regs, 0 B stack, 0 B spill",
    "convex_rare_kernel<double>: 106 regs, 0 B stack, 0 B spill",
    "convex_rare_kernel<float>: 62 regs, 0 B stack, 0 B spill",
    "convex_stream_kernel<double, admitted>: 170 regs, 0 B stack, 0 B spill",
    "convex_stream_kernel<double, crossers>: 69 regs, 0 B stack, 0 B spill",
    "convex_stream_kernel<double, philox, admitted>: 170 regs, 40 B stack, 0 B spill",
    "convex_stream_kernel<double, philox, crossers>: 90 regs, 40 B stack, 0 B spill",
    "convex_stream_kernel<double, philox>: 170 regs, 40 B stack, 0 B spill",
    "convex_stream_kernel<double>: 170 regs, 0 B stack, 0 B spill",
    "convex_stream_kernel<float, admitted>: 80 regs, 16 B stack, 12 B spill",
    "convex_stream_kernel<float, crossers>: 54 regs, 0 B stack, 0 B spill",
    "convex_stream_kernel<float, philox, admitted>: 80 regs, 32 B stack, 16 B spill",
    "convex_stream_kernel<float, philox, crossers>: 54 regs, 32 B stack, 0 B spill",
    "convex_stream_kernel<float, philox>: 80 regs, 32 B stack, 16 B spill",
    "convex_stream_kernel<float>: 80 regs, 16 B stack, 12 B spill",
    "hop_admit_kernel: 32 regs, 0 B stack, 0 B spill",
    "macro_stream_kernel<double, admitted>: 94 regs, 0 B stack, 0 B spill",
    "macro_stream_kernel<double, crossers>: 68 regs, 0 B stack, 0 B spill",
    "macro_stream_kernel<double, philox, admitted>: 104 regs, 40 B stack, 0 B spill",
    "macro_stream_kernel<double, philox, crossers>: 82 regs, 40 B stack, 0 B spill",
    "macro_stream_kernel<double, philox>: 128 regs, 56 B stack, 12 B spill",
    "macro_stream_kernel<double>: 96 regs, 0 B stack, 0 B spill",
    "macro_stream_kernel<float, admitted>: 53 regs, 0 B stack, 0 B spill",
    "macro_stream_kernel<float, crossers>: 40 regs, 0 B stack, 0 B spill",
    "macro_stream_kernel<float, philox, admitted>: 60 regs, 32 B stack, 0 B spill",
    "macro_stream_kernel<float, philox, crossers>: 48 regs, 32 B stack, 0 B spill",
    "macro_stream_kernel<float, philox>: 62 regs, 32 B stack, 0 B spill",
    "macro_stream_kernel<float>: 64 regs, 0 B stack, 0 B spill",
    "rare_kernel<double, pk>: 112 regs, 32 B stack, 0 B spill",
    "rare_kernel<double>: 80 regs, 32 B stack, 0 B spill",
    "rare_kernel<float, pk>: 63 regs, 16 B stack, 0 B spill",
    "rare_kernel<float>: 48 regs, 16 B stack, 0 B spill",
    "stream_kernel<double, admitted>: 90 regs, 0 B stack, 0 B spill",
    "stream_kernel<double, crossers>: 65 regs, 0 B stack, 0 B spill",
    "stream_kernel<double, philox, admitted>: 106 regs, 40 B stack, 0 B spill",
    "stream_kernel<double, philox, crossers>: 78 regs, 40 B stack, 0 B spill",
    "stream_kernel<double, philox, pk>: 124 regs, 40 B stack, 0 B spill",
    "stream_kernel<double, philox>: 106 regs, 40 B stack, 0 B spill",
    "stream_kernel<double, pk>: 115 regs, 0 B stack, 0 B spill",
    "stream_kernel<double>: 90 regs, 0 B stack, 0 B spill",
    "stream_kernel<float, admitted>: 55 regs, 0 B stack, 0 B spill",
    "stream_kernel<float, crossers>: 40 regs, 0 B stack, 0 B spill",
    "stream_kernel<float, philox, admitted>: 53 regs, 32 B stack, 0 B spill",
    "stream_kernel<float, philox, crossers>: 48 regs, 32 B stack, 0 B spill",
    "stream_kernel<float, philox, pk>: 64 regs, 32 B stack, 0 B spill",
    "stream_kernel<float, philox>: 56 regs, 32 B stack, 0 B spill",
    "stream_kernel<float, pk>: 61 regs, 0 B stack, 0 B spill",
    "stream_kernel<float>: 48 regs, 0 B stack, 0 B spill",
    # the measuring cluster barrier (csrc/probe.cu; <1>: relaxed, <2>: warp 0
    # releases, the AMG tail's) and shared memory chase (<1>: another block's)
    "cluster_sync_kernel<0>: 8 regs, 0 B stack, 0 B spill",
    "cluster_sync_kernel<1>: 8 regs, 0 B stack, 0 B spill",
    "cluster_sync_kernel<2>: 8 regs, 0 B stack, 0 B spill",
    "smem_chase_kernel<0>: 14 regs, 0 B stack, 0 B spill",
    "smem_chase_kernel<1>: 23 regs, 0 B stack, 0 B spill",
)
# the pressure solve's kernels (csrc/amg.cu): the matvec and level kernels
# (their lines unchanged by the tail), and the tail's two instantiations
# (the tail plan's kernel)
PINNED_AMG_PTXAS = (
    "amg_down_kernel<double>: 48 regs, 0 B stack, 0 B spill",
    "amg_down_kernel<float>: 32 regs, 0 B stack, 0 B spill",
    "amg_up_kernel<double>: 46 regs, 0 B stack, 0 B spill",
    "amg_up_kernel<float>: 32 regs, 8 B stack, 8 B spill",
    "fv_matvec_kernel<double, k=1>: 32 regs, 0 B stack, 0 B spill",
    "fv_matvec_kernel<double, k=2>: 32 regs, 0 B stack, 0 B spill",
    "fv_matvec_kernel<double, k=3>: 32 regs, 0 B stack, 0 B spill",
    "fv_matvec_kernel<float, k=1>: 32 regs, 0 B stack, 0 B spill",
    "fv_matvec_kernel<float, k=2>: 32 regs, 0 B stack, 0 B spill",
    "fv_matvec_kernel<float, k=3>: 32 regs, 0 B stack, 0 B spill",
    "amg_tail_kernel<double>: 128 regs, 32 B stack, 116 B spill",
    "amg_tail_kernel<float>: 128 regs, 0 B stack, 0 B spill",
)


def register_report(_build, lines):
    """Phase 9e: ptxas's registers, stack and spills of each RK4
    instantiation of stream_kernel, and every other kernel's line against
    PINNED_PTXAS (compared where this build's nvcc is the pinned one)."""
    rk4 = [line for line in lines if "rk4" in line.split(":")[0]]
    # the partitioned shard's rare_kernel<T, L, kRemote> (phase 12), new too
    remote = [line for line in lines if "remote" in line.split(":")[0]]
    # the pressure solve's kernels (csrc/amg.cu, phase 14), new as well
    amg = [line for line in lines if line.split("<")[0] in AMG_KERNEL_NAMES]
    # the pack and unpack of run_cycles (csrc/pack.cu, phase 5e), new too
    pack = [line for line in lines if line.split("<")[0] in PACK_KERNEL_NAMES]
    rest = sorted(line for line in lines if line not in rk4 + remote + amg + pack)
    for line in rk4 + remote + amg + pack:
        log(f"[registers] {line}")
    if not lines:
        log("[registers] unchanged_against_pinned=skipped: the library was built before "
            "this process")
        return
    out = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60).stdout
    if PINNED_NVCC not in out:
        log(f"[registers] unchanged_against_pinned=skipped: this nvcc is not "
            f"{PINNED_NVCC!r} ({out.strip()!r})")
        return
    changed = sorted(set(PINNED_PTXAS) ^ set(rest))
    amg_changed = sorted(set(PINNED_AMG_PTXAS) ^ set(amg))
    log(f"[registers] rk4_instantiations={len(rk4)} remote_instantiations={len(remote)} "
        f"amg_instantiations={len(amg)} pack_instantiations={len(pack)} "
        f"other_kernels={len(rest)} "
        f"unchanged_against_pinned={int(not changed)} amg_unchanged_against_pinned="
        f"{int(not amg_changed)} (nvcc {PINNED_NVCC})")
    need(len(rk4) == 8 and len(remote) == 4 and len(amg) == 12 and len(pack) == 8
         and not changed and not amg_changed,
         f"ptxas lines differ from the pinned ones: {changed}, AMG {amg_changed}, or not 8 RK4 "
         f"lines: {rk4}, or not 4 remote lines: {remote}, or not 12 AMG lines: {amg}, or not "
         f"8 pack lines: {pack}")


def ptxas_lines(report):
    """One 'kernel<type>: registers, stack' entry per compiled kernel."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            # _ZN3cpf<len><kernel>[I<d|f>[Lb<0|1>E][Li<pass>E]E]...: the type
            # and, for the stream kernels, whether the Philox noise is
            # compiled in and the pass (stream.cuh)
            rest = line.split("'")[1].split("cpf", 1)[1]
            digits = rest[: len(rest) - len(rest.lstrip("0123456789"))]
            base = rest[len(digits): len(digits) + int(digits)]
            targs = rest[len(digits) + int(digits):]
            name = base
            if base in PACK_KERNEL_NAMES:
                # pack.cu: <T> and pack_kernel's (W, TW)
                args = [{"d": "double", "f": "float"}[targs[1]]] + re.findall(
                    r"Li(\d+)E", targs.split("EE", 1)[0] + "E")
                name = f"{base}<{', '.join(args)}>"
            elif base in AMG_KERNEL_NAMES:
                # amg.cu: <T> and fv_matvec's K columns
                args = [{"d": "double", "f": "float"}[targs[1]]]
                flag = re.search(r"L[bi](\d+)E", targs)
                if flag:
                    args.append(f"k={flag.group(1)}")
                name = f"{base}<{', '.join(args)}>"
            elif targs.startswith(("ILi", "ILb")):
                name = f"{base}<{re.match(r'IL[bi](-?\d+)E', targs).group(1)}>"
            elif targs.startswith("I"):
                args = [{"d": "double", "f": "float"}[targs[1]]]
                flags = re.findall(r"L[bi](\d+)E", targs.split("EE", 1)[0] + "E")
                remote = base == "rare_kernel" and bool(flags) and flags[0] == "1"
                if flags and flags[0] == "1" and not remote:
                    args.append("philox")
                if len(flags) > 1 and flags[1] != "0":
                    args.append(("", "crossers", "admitted")[int(flags[1])])
                if "8LayoutPk" in targs.split("EE", 1)[0]:
                    args.append("pk")
                if len(flags) > 2 and flags[2] == "1":
                    args.append("rk4")
                if remote:
                    args.append("remote")
                name = f"{base}<{', '.join(args)}>"
        elif name and "bytes stack frame" in line:
            stack = line.split("bytes stack frame")[0].split()[-1]
            spill = line.split("bytes spill stores")[0].split()[-1]
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} regs, {stack} B stack, {spill} B spill")
            name = None
    return out


# ---------------------------------------------------------------------------
# phase 10: the steady-flow solver (models/{fv,simple,turbulence,functions}.py)
# ---------------------------------------------------------------------------

FLOW_N0 = 20          # CPU iterations before the card and the CPU start from one state
FLOW_ITERS = 10       # compared iterations
FLOW_TOL = 1e-9       # float64, relative to each field's largest magnitude
# the 10a cases (tests/torch_port_common.py FLOW_PARITY); limitedLinear runs on
# the 3-D duct: on the 2-D channel JAX's V-limiter takes the min over
# components, one of which is the empty direction's rounding noise, so the
# run follows ulps (its line below is printed and not checked)
FLOW_CARD_CASES = ("linearUpwind-cg", "linearUpwind", "limitedLinear-cg", "limitedLinear",
                   "kOmegaSST")
# --iters of 10b's simple, a cut of the tutorial's 500 (residualControl never
# stops it): simple clamps its write into the particle window, to 282
SIMPLE_ITERS_CAP = 100
UNCHECKED_2D = ("not checked (2-D limitedLinear: the V-limiter follows the empty direction's "
                "rounding noise)")


def flow_common(torch):
    """tests/torch_port_common.py (the flow cases and the SIMPLE loop of the
    port's tests), without the one-thread cap it sets for pytest workers."""
    threads = torch.get_num_threads()
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_port_common

    torch.set_num_threads(threads)
    return torch_port_common


def moved_to(obj, dev):
    """A dataclass of tensors with every tensor field on ``dev``."""
    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


def flow_setup(torch, case, pm, dev, solver, scheme, n_nonortho, p_tol, dtype):
    from cudaparticlesfoam_tpu_torch.models import fv, simple, turbulence

    m, st, ub, pb, nu, pin, _ = simple.load_flow_case(case, pm=pm, dtype=dtype, device=dev)
    cfg = simple.SimpleConfig(nu=nu, pin_pressure=pin, div_scheme=scheme, p_solver=solver,
                              n_nonortho=n_nonortho, p_tol=p_tol)
    amg = fv.build_amg(m) if solver == "amg" else None
    model = simple.turbulence_model(case)
    cl = None if model == "laminar" else (model,) + tuple(turbulence.init_model(model, case, m))
    return m, st, ub, pb, cfg, amg, cl


def flow_fields(st, cl):
    out = {k: getattr(st, k) for k in ("u", "p", "flux")}
    if cl is not None:
        out.update({k: getattr(cl[1], k) for k in ("k", "eps", "omega", "nut")
                    if hasattr(cl[1], k)})
    return out


def phase_flow_parity(torch, dev, tmp, rehearse, gpu_line):
    """Phase 10a: SIMPLE on the card against the port on the CPU, float64,
    from one state (the CPU's after FLOW_N0 iterations; pitzDaily from its
    cold start): FLOW_ITERS iterations each, the fields within FLOW_TOL of
    each field's largest magnitude, the CG counts side by side (AMG-CG
    equal or within one; Jacobi-CG within 1%), and the card run twice."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh
    from cudaparticlesfoam_tpu_torch.models import simple, turbulence

    common = flow_common(torch)
    cpu = torch.device("cpu")
    runs = [(name,) + common.FLOW_PARITY[name] + (FLOW_N0, True) for name in FLOW_CARD_CASES]
    runs.append(("limitedLinear-2d", "channel", "amg", "limitedLinear", 0, 1e-7, FLOW_N0, False))
    if not rehearse:
        runs.append(("pitzDaily-kEpsilon", None, "amg", "linearUpwind", 0, 1e-7, 0, True))
    made = {}
    for name, flow, solver, scheme, nno, p_tol, n0, checked in runs:
        t0 = time.perf_counter()
        if flow is None:
            case = PITZ
        else:
            case = made.get(flow) or common.make_flow_case(tmp, flow)
            made[flow] = case
        pm = blockmesh.generate(os.path.join(case, "system", "blockMeshDict"))
        kw = dict(solver=solver, scheme=scheme, n_nonortho=nno, p_tol=p_tol,
                  dtype=torch.float64)
        m, st, ub, pb, cfg, amg, cl = flow_setup(torch, case, pm, cpu, **kw)
        st, cl, _ = common.simple_steps(simple, turbulence, m, st, ub, pb, cfg, amg, cl, n0)
        ref_st, ref_cl, ref_its = common.simple_steps(simple, turbulence, m, st, ub, pb, cfg, amg,
                                                      cl, FLOW_ITERS)
        dm, _, dub, dpb, dcfg, damg, dcl = flow_setup(torch, case, pm, dev, **kw)
        dst = moved_to(st, dev)
        if dcl is not None:
            dcl = (dcl[0], moved_to(cl[1], dev)) + dcl[2:]
        card = [common.simple_steps(simple, turbulence, dm, dst, dub, dpb, dcfg, damg, dcl,
                                    FLOW_ITERS) for _ in range(2)]
        want = flow_fields(ref_st, ref_cl)
        errs = {}
        for k, v in flow_fields(card[0][0], card[0][1]).items():
            ref = want[k]
            errs[k] = float((v.cpu() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)
        again = flow_fields(card[1][0], card[1][1])
        identical = all(bool(torch.equal(v, again[k]))
                        for k, v in flow_fields(card[0][0], card[0][1]).items())
        its = card[0][2]
        diffs = [a - b for a, b in zip(its, ref_its)]
        count_ok = all(abs(d) <= (1 if solver == "amg" else max(1, 0.01 * b))
                       for d, b in zip(diffs, ref_its))
        finite = all(bool(torch.isfinite(v).all()) for v in flow_fields(*card[0][:2]).values())
        worst = max(errs.values())
        log(f"[flow-parity] {gpu_line} | {name}: {m.n_cells} cells, {solver} {scheme} "
            f"n_nonortho={nno} p_tol={p_tol:g}, float64, {n0}+{FLOW_ITERS} iterations: "
            f"max_rel_err={worst:.3e} by field { {k: f'{v:.2e}' for k, v in errs.items()} } "
            f"cg_card={its} cg_cpu={ref_its} cg_diff={diffs} second_card_run_identical="
            f"{int(identical)} finite={int(finite)} "
            f"{'checked' if checked else UNCHECKED_2D} "
            f"s={time.perf_counter() - t0:.1f}")
        need(finite, f"flow parity {name}: non-finite fields on the card")
        if checked:
            need(worst <= FLOW_TOL, f"flow parity {name}: card against CPU {worst:.3e}")
            need(count_ok, f"flow parity {name}: CG counts {its} against {ref_its}")


def read_vtk_polylines(path):
    """(points, lines) of a legacy-VTK POLYDATA file (the streamLine
    writer's): the POINTS block as [n, 3] and each LINES entry's ids."""
    with open(path) as fh:
        tokens = fh.read().split()
    need(tokens[tokens.index("DATASET") + 1] == "POLYDATA", f"{path} is not POLYDATA")
    i = tokens.index("POINTS")
    n = int(tokens[i + 1])
    pts = np.array(tokens[i + 3:i + 3 + 3 * n], dtype=float).reshape(n, 3)
    j = tokens.index("LINES")
    n_lines, k, lines = int(tokens[j + 1]), j + 3, []
    for _ in range(n_lines):
        cnt = int(tokens[k])
        lines.append([int(x) for x in tokens[k + 1:k + 1 + cnt]])
        k += 1 + cnt
    return pts, lines


def phase_flow_tutorial(torch, dev, tmp, rehearse, gpu_line, shear):
    """Phase 10b: the tutorial's Allrun (tutorials/.../pitzDaily/Allrun)
    through the port's CLI in subprocesses, float32, in a copy of the
    repo's pitzDaily: blockmesh, dict deltaT 1.0, simple (SIMPLE_ITERS_CAP
    of its 500 iterations), dict deltaT 0.1, uncoupled at the
    tutorial's settings; the rehearsal runs simple --iters 5 on the CPU and
    the tracker at 2,000 particles, deltaT 0.01.  ``shear``: phase 8b's
    numbers, for Advect on the shear field beside the solved one.  Returns
    (case dir, written time, the simple run's pressure-solve kernel
    launches by wrapper: the CLI logs them on the card)."""
    import shutil

    from cudaparticlesfoam_tpu_torch.io import foamfile, polymesh

    case = os.path.join(tmp, "pitzDaily")
    shutil.copytree(PITZ, case)
    if rehearse:
        path = os.path.join(case, "system", "cudaParticlesDict")
        d = foamfile.read(path)
        d.pop("FoamFile", None)
        d["numParticles"] = 2_000
        foamfile.write(path, d, obj_name="cudaParticlesDict")
    dev_args = ["--device", "cpu"] if rehearse else []
    iters = 5 if rehearse else SIMPLE_ITERS_CAP
    control = os.path.join(case, "system", "controlDict")
    steps = [("blockmesh", ["blockmesh", case]),
             ("dict", ["dict", control, "-entry", "deltaT", "-set", "1.0"]),
             ("simple", ["simple", case] + dev_args + (["--iters", str(iters)] if iters else []))]
    out = {}
    for name, args in steps:
        res, secs = cli(args)
        need(res.returncode == 0, f"Allrun step {name} failed: {res.stderr[-3000:]}")
        out[name] = (res.stdout, secs)
    text, simple_s = out["simple"]
    conv = re.search(r"SIMPLE converged in (\d+) iterations \(initial residual ([\d.e+-]+)\)",
                     text)
    flow = re.search(r"#flow: SIMPLE (\d+) iterations: ([\d.]+) ms/iteration on the "
                     r"(?:device, ([\d.]+) ms/iteration on the host|CPU).*?min/mean/max "
                     r"(\d+)/([\d.]+)/(\d+)(?:; on (.*), peak device memory ([\d.]+) GiB)?", text)
    need(flow is not None, "simple printed no #flow line")
    n_iter = int(flow.group(1))
    solver = re.search(r"solver kernel launches (\{.*?\})", text)
    launches = json.loads(solver.group(1).replace("'", '"')) if solver else {}
    times = sorted(float(d) for d in os.listdir(case)
                   if re.fullmatch(r"[\d.]+", d) and float(d) > 0
                   and os.path.exists(os.path.join(case, d, "U")))
    need(len(times) == 1, f"simple wrote the times {times}")
    t_write = f"{times[0]:g}"
    pm = polymesh.read_polymesh(os.path.join(case, "constant", "polyMesh"))
    u = polymesh.read_field(os.path.join(case, t_write, "U"), n_cells=pm.n_cells)
    p = polymesh.read_field(os.path.join(case, t_write, "p"), n_cells=pm.n_cells)
    phi = polymesh.read_surface_field(os.path.join(case, t_write, "phi"),
                                      [pt[0] for pt in pm.patches])
    umax = float(np.linalg.norm(u, axis=1).max())
    finite = bool(np.isfinite(u).all() and np.isfinite(p).all()
                  and (phi is None or np.isfinite(phi).all()))
    tracks = os.path.join(case, "postProcessing", "streamlines", t_write, "tracks.vtk")
    need(os.path.exists(tracks), f"no streamline file {tracks}")
    pts, lines = read_vtk_polylines(tracks)
    phases = {m_.group(1): [float(x) for x in m_.group(2).split("\t") if x]
              for m_ in re.finditer(r"^\t(Mesh|SIMPLE|IO|Streamlines)\t([\d.\t]+)$", text, re.M)}
    simple_line = (
        f"[flow-allrun] {gpu_line} | pitzDaily Allrun via the CLI, simple: "
        f"iterations={n_iter} converged={int(conv is not None)}"
        f"{f' (initial residual {conv.group(2)})' if conv else ''} iters_cap="
        f"{iters if iters else 'none'} ms_per_iteration={flow.group(2)} "
        f"host_ms_per_iteration={flow.group(3) or flow.group(2)} cg_per_solve_min_mean_max="
        f"{flow.group(4)}/{flow.group(5)}/{flow.group(6)} peak_device_GiB={flow.group(8)} "
        f"phases_s={ {k: v[0] for k, v in phases.items()} } simple_command_s={simple_s:.1f} "
        f"solver_kernel_launches={launches} "
        f"written_time={t_write} max_U={umax:.3f} finite={int(finite)} "
        f"U_p_phi_read={int(phi is not None)} streamlines={len(lines)} "
        f"streamline_points={len(pts)}")
    log(simple_line)
    need(finite and umax < 50.0, f"simple's field: finite={finite}, max |U| {umax}")
    need(282.0 <= times[0] <= 382.0, f"simple wrote at {t_write}, outside [282, 382]")
    need(phi is not None and len(phi) == pm.n_faces, "phi does not read back")
    need(len(lines) == 10 and all(len(ln) > 1 for ln in lines) and np.isfinite(pts).all(),
         "the streamline file does not parse")
    res, _ = cli(["dict", control, "-entry", "deltaT", "-set", "0.01" if rehearse else "0.1"])
    need(res.returncode == 0, f"Allrun step dict failed: {res.stderr[-3000:]}")
    _, tut = tutorial_cli_run(
        torch, dev, case, os.path.join(tmp, "frames"), rehearse, gpu_line, "flow-allrun",
        f"pitzDaily Allrun via the CLI, uncoupled on the solved U at {t_write}",
        extra=lambda info: (f" mean_x_first_last={info['mean_x'][0]:.6f},"
                            f"{info['mean_x'][1]:.6f} advect_ms_per_cycle_shear_field_8b="
                            f"{shear['adv_ms']:.4f}"))
    need(tut["mean_x"][1] > tut["mean_x"][0], f"the particles did not move downstream "
         f"(mean x {tut['mean_x']})")
    return case, t_write, launches


def profile_part(torch, dev, fn):
    """(kernels, launch calls, kernel busy ms) of one call of ``fn`` under
    torch.profiler; on the CPU (no CUDA activity) (None, None, None)."""
    if dev.type != "cuda":
        return None, None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    raw = getattr(getattr(prof.profiler, "kineto_results", None), "events", None)
    raw = raw() if raw is not None else []
    launches = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")
    if raw and all(hasattr(raw[0], k) for k in ("duration_ns", "device_type", "name")):
        # the raw records, as profile_kernels reads them
        ns = [e.duration_ns() for e in raw if e.device_type() == DeviceType.CUDA
              and not e.name().startswith(("Memcpy", "Memset"))]
        calls = sum(e.name() in launches for e in raw)
        return len(ns), calls, sum(ns) / 1e6
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    calls = [e for e in events if e.name in launches]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return len(kernels), len(calls), busy


def unmeasured(x, fmt="%s"):
    return "not measured (CPU)" if x is None else fmt % x


def measure_part(torch, dev, fn, reps=3):
    """Median device ms (CUDA events; on the CPU the host clock after the
    call), median host ms to issue (no synchronisation after the call), and
    the profiler's kernels, launch calls and kernel busy ms of one call."""
    fn()
    timer, dev_ms, host_ms = Timer(torch, dev), [], []
    for _ in range(reps):
        timer.start()
        h0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        dev_ms.append(timer.stop())
    kernels, calls, busy = profile_part(torch, dev, fn)
    return {"ms": float(np.median(dev_ms)), "host_ms": float(np.median(host_ms)),
            "kernels": kernels, "launch_calls": calls, "busy_ms": busy, "samples_ms": dev_ms}


def phase_flow_split(torch, dev, case, t_write, gpu_line, warm):
    """Phase 10c: one SIMPLE iteration on pitzDaily, float32, split into its
    stages, at 10b's state (U and p as written at ``t_write``, the closure
    from 0/, then ``warm`` iterations in process): each part's device ms,
    the host's ms to issue it, its kernels and launch calls
    (torch.profiler) and the kernels' busy ms; the pressure solve as its CG
    iterations x one, and one V-cycle alone.  Calls the package's stage
    functions in simple_iteration's order; changes nothing in it."""
    from cudaparticlesfoam_tpu_torch.models import fv, simple, turbulence

    common = flow_common(torch)
    m, st, ub, pb, nu, pin, _ = simple.load_flow_case(case, dtype=torch.float32, time_dir=t_write,
                                                      device=dev)
    num = simple.read_numerics(case)
    cfg = simple.SimpleConfig(nu=nu, pin_pressure=pin, div_scheme=num["div_scheme"],
                              n_nonortho=num["n_nonortho"], p_solver="amg")
    amg = fv.build_amg(m)
    model = simple.turbulence_model(case)
    cl = (model,) + tuple(turbulence.init_model(model, case, m))
    st, cl, _ = common.simple_steps(simple, turbulence, m, st, ub, pb, cfg, amg, cl, warm)
    _, kes, ba, bb, wi = cl

    nut_bd = turbulence.wall_nut_bd(m, wi, kes.nut, kes.k, cfg.nu)
    mo = simple.momentum_predictor(m, st, ub, pb, cfg, nut=kes.nut, nut_bd=nut_bd)
    rau, hbya, phi_hbya, rau_f, Ap, rhs = simple.pressure_system(m, mo, pb, cfg)
    p_new, corr, _, its = simple.pressure_solve(m, Ap, rhs, st.p, rau_f, pb, cfg, amg)
    levels = fv.amg_coarse_ops(m, amg, Ap)
    new, _ = simple.correct(m, st, rau, hbya, phi_hbya, rau_f, p_new, corr, pb, cfg)
    parts = {
        "momentum (wall nut, assembly, Jacobi, residuals)": lambda: (
            turbulence.wall_nut_bd(m, wi, kes.nut, kes.k, cfg.nu),
            simple.momentum_predictor(m, st, ub, pb, cfg, nut=kes.nut, nut_bd=nut_bd)),
        "pressure system (HbyA, flux, Laplacian)": lambda: simple.pressure_system(m, mo, pb,
                                                                                  cfg),
        "pressure solve (AMG-CG)": lambda: simple.pressure_solve(m, Ap, rhs, st.p, rau_f, pb,
                                                                 cfg, amg),
        "corrections": lambda: simple.correct(m, st, rau, hbya, phi_hbya, rau_f, p_new, corr,
                                              pb, cfg),
        f"{model} step": lambda: turbulence.model_step(model, m, kes, new.u, ub, new.flux, ba,
                                                       bb, wi, cfg.nu),
    }
    def whole():
        return common.simple_steps(simple, turbulence, m, st, ub, pb, cfg, amg, cl, 1)

    extra = {
        "coarse operators (in the solve, once)": lambda: fv.amg_coarse_ops(m, amg, Ap),
        "one V-cycle": lambda: fv.amg_vcycle(m, amg, Ap, levels, rhs),
        "whole iteration, again": whole,
    }
    out = {}
    # the whole iteration first, before any profiler session, and again last
    for name, fn in [("whole iteration", whole)] + list(parts.items()) + list(extra.items()):
        r = measure_part(torch, dev, fn)
        out[name] = r
        per = (f" cg_iterations={its} ms_per_cg_iteration={r['ms'] / max(its, 1):.4f}"
               if name.startswith("pressure solve") else "")
        log(f"[flow-split] {gpu_line} | pitzDaily at t={t_write}, {m.n_cells} cells, float32, "
            f"{name}: ms={r['ms']:.4f} host_issue_ms={r['host_ms']:.4f} "
            f"kernels={unmeasured(r['kernels'])} launch_calls={unmeasured(r['launch_calls'])} "
            f"kernel_busy_ms={unmeasured(r['busy_ms'], '%.4f')}{per}")
    first, again = out["whole iteration"], out["whole iteration, again"]
    sum_ms = sum(out[k]["ms"] for k in parts)
    idle = (1.0 - first["busy_ms"] / first["ms"]) if first["busy_ms"] is not None else None
    log(f"[flow-split] {gpu_line} | one SIMPLE iteration: parts_sum_ms={sum_ms:.4f} "
        f"whole_ms={first['ms']:.4f} whole_again_ms={again['ms']:.4f} "
        f"kernels_per_iteration={first['kernels']} "
        f"device_idle_share={'%.3f' % idle if idle is not None else 'not measured'} "
        f"cg_iterations={its}")
    need(its > 0 and all(np.isfinite(r["ms"]) for r in out.values()), "the split did not run")
    return dict(m=m, h=amg, A=Ap, b=rhs, x0=st.p, tol=cfg.p_tol, max_iter=cfg.p_max_iter,
                whole=whole)



# ---------------------------------------------------------------------------
# phase 11: the coupled solver (models/{pimple,coupled,mrf,fvoptions,
# dynamicmesh,motionsolver}.py: torch ops, no kernel) and the TJunction
# through the kernels on a field that changes every step
# ---------------------------------------------------------------------------

# the phases whose kernel-against-plain comparisons feed each entry's max_abs_err
ERR_PHASES = {
    "stream": "3, 3c, 3d, 5, 5c, 11b", "rare": "3, 5, 11b",
    "convex_stream": "3b, 3c, 3d, 5b, 5c",
    "convex_rare": "3b, 5b", "hop_admit": "3d, 5c", "macro": "3e, 5c", "stream_pk": "3f, 5d",
    "rare_pk": "3f, 5d", "stream_tutorial": "8c", "rare_tutorial": "8c",
    "stream_rk4": "9d", "rare_rk4": "9d", "stream_pk_rk4": "9d", "rare_pk_rk4": "9d",
    "stream_tjunction": "11c", "rare_tjunction": "11c", "stream_dp": "12b", "rare_dp": "12b",
    "stream_tjunction_par": "13c", "rare_tjunction_par": "13c",
    "rare_remote": "12a, 12b", "rare_pk_remote": "12a, 12b",
    "fv_matvec": "14a", "amg_down": "14a", "amg_up": "14a", "amg_tail": "14a"}
TJUNC = os.path.join(HERE, "tutorials", "incompressible", "cudaParticlesPimpleFoam", "TJunction")
TJUNC_PATH = "coupled driver (TJunction, 248,000 cells, 4e6 particles, 3 Eulerian steps)"
PIMPLE_TOL = 1e-9         # float64 card against CPU, relative to each field's largest magnitude
PIMPLE_STEPS = 5
TJ_STEPS = 3              # cut (i): JAX's own reference-scale check ran 3 steps
TJ_SAVE_INTERVAL = 20     # cut (iii): at most 3 frames of 4e6 particles
TJ_BOUND_S = 240          # 11c's wall time on the card
WHOLE_REPS = 5            # 11d: timed samples of a whole PIMPLE step in each of its two runs
WARM_FILLS = 64           # 11c's Advect trace: device events for the profiler to drop


def pimple_fields(flow):
    out = {k: getattr(flow.state, k) for k in ("u", "p", "flux")}
    if flow.kes is not None:
        out.update({k: getattr(flow.kes, k) for k in ("k", "eps", "omega")
                    if hasattr(flow.kes, k)})
    if flow.fvo is not None and flow.fvo.has_mvf:
        out["grad_p"] = flow.fvo.grad_p
    return out


def phase_pimple_parity(torch, dev, tmp, gpu_line):
    """Phase 11a: the PIMPLE solver (FlowSolver.from_case + advance) on the
    card against the port on the CPU, float64, three cases: the shrunk
    TJunction (kEpsilon, AMG-CG, the p0 ramps, PIMPLE_STEPS steps at the
    case's adjustable dt), tests/test_mrf.py's spun box (MRF, one step) and
    tests/test_fvoptions.py's meanVelocityForce channel (PIMPLE_STEPS
    steps, grad_p compared too); the fields within PIMPLE_TOL of each
    field's largest magnitude, the AMG-CG counts equal, the card run twice
    (bit for bit or not is printed: index_add_ sums with atomics)."""
    from cudaparticlesfoam_tpu_torch.config import ControlConfig
    from cudaparticlesfoam_tpu_torch.io import polymesh
    from cudaparticlesfoam_tpu_torch.models import pimple

    common = flow_common(torch)
    cpu = torch.device("cpu")
    tj = common.shrink_tjunction(os.path.join(tmp, "tj"))
    common.write_polymesh_of(tj)
    cases = (("TJunction-kEpsilon", tj, None, PIMPLE_STEPS),
             ("MRF-box", common.make_mrf_case(os.path.join(tmp, "mrf")), 0.01, 1),
             ("meanVelocityForce-channel", common.make_mvf_channel_case(os.path.join(tmp, "mvf")),
              0.02, PIMPLE_STEPS))
    for name, case, dt, n_steps in cases:
        t0 = time.perf_counter()
        pm_of = lambda: polymesh.read_polymesh(os.path.join(case, "constant", "polyMesh"))  # noqa
        quiet = lambda *a: None  # noqa: E731
        solvers = [pimple.FlowSolver.from_case(common.FakeCase(case, pm_of()), log=quiet,
                                               dtype=torch.float64, device=d)
                   for d in (cpu, dev, dev)]
        ctrl = ControlConfig.from_case(case)
        its = [[], [], []]
        dts = []
        for _ in range(n_steps):
            dt_e = dt if dt is not None else solvers[0].stable_dt(ctrl)
            dts.append(dt_e)
            for i, s in enumerate(solvers):
                its[i] += s.advance(dt_e)["p_iters"]
        want = pimple_fields(solvers[0])
        got, again = pimple_fields(solvers[1]), pimple_fields(solvers[2])
        errs = {k: float((v.cpu() - want[k]).abs().max()) / max(float(want[k].abs().max()),
                                                               1e-300)
                for k, v in got.items()}
        identical = all(bool(torch.equal(v, again[k])) for k, v in got.items())
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())
        worst = max(errs.values())
        log(f"[pimple-parity] {gpu_line} | {name}: {solvers[0].m.n_cells} cells, "
            f"{solvers[0].cfg.p_solver} {solvers[0].cfg.div_scheme} {solvers[0].turb_model} "
            f"mrf={int(solvers[0].mrf is not None)} fvOptions={int(solvers[0].fvo is not None)}, "
            f"float64, {n_steps} steps dt={[f'{x:.4g}' for x in dts]}: max_rel_err={worst:.3e} "
            f"by field { {k: f'{v:.2e}' for k, v in errs.items()} } cg_card={its[1]} "
            f"cg_cpu={its[0]} cg_equal={int(its[1] == its[0])} second_card_run_identical="
            f"{int(identical)} finite={int(finite)} s={time.perf_counter() - t0:.1f}")
        need(finite and worst <= PIMPLE_TOL, f"pimple parity {name}: card against CPU {worst:.3e}")
        need(its[1] == its[0], f"pimple parity {name}: AMG-CG counts {its[1]} against {its[0]}")
        if name.startswith("meanVelocity"):
            need(float(want["grad_p"]) != 0.0, "the meanVelocityForce controller did not act")


def tet_payload_of(case, dtype):
    """(host payload, tet -> cell) of a case's polyMesh, and the PolyMesh."""
    from cudaparticlesfoam_tpu_torch.io import polymesh

    pm = polymesh.read_polymesh(os.path.join(case, "constant", "polyMesh"))
    host, tet_cell = polymesh.mesh_host_from_polymesh(pm, u_cells=None, dtype=dtype)
    return host, tet_cell, pm


def phase_dynamic_mesh(torch, cpt, fused, fused_cuda, tmesh, dev, tmp, nside, n, errs,
                       gpu_line):
    """Phase 11b: refresh_geometry on the card = on the CPU = a rebuild from
    the moved points (float64, within 1e-12; every row table: tet_row,
    tet_row_pk32, tet_row_cx, tet_row_cxe), on an nside^3 cube moved by a
    solidBody rotation and by a velocityLaplacian step; then stream_kernel
    and rare_kernel on the rotated float32 mesh against their plain
    versions at n and n - RAGGED lanes (phase 3's tolerances); then
    tests/test_dynamicmesh.py's oscillating box through run_coupled on the
    card against the CPU, float64, the same replayed noise."""
    import copy

    from cudaparticlesfoam_tpu_torch.models import coupled
    from cudaparticlesfoam_tpu_torch.models import dynamicmesh as dyn

    common = flow_common(torch)
    cpu = torch.device("cpu")
    case = common.refresh_box_case(tmp, nside)
    host, tet_cell, pm = tet_payload_of(case, np.float64)
    motions = (("rotatingMotion", dyn.SolidBodyMotion(kind="rotatingMotion", omega=0.5,
                                                      origin=(0.5, 0.5, 0.5)), 0.3, 0.3),
               ("velocityLaplacian", dyn.read_dynamic_mesh(case), 0.05, 0.05))
    keys = ("points", "tet_a", "tet_tinv", "tet_face_n", "tet_face_d", "tet_row", "tet_row_pk32",
            "tet_row_cx", "tet_row_cxe", "bounds_lo", "bounds_hi")
    verts_rot = None
    for name, motion, t, dt in motions:
        dm = dyn.DynamicMesh(motion, copy.deepcopy(pm), dtype=torch.float64, device=cpu)
        m_new, _, _ = dm.update(t, dt)
        verts = dm.tet_vertices(m_new)
        verts_rot = verts if verts_rot is None else verts_rot
        meshes = [cpt.with_pk_rows(cpt.with_convex_rows(tmesh.host_to_device(host, d)))
                  for d in (cpu, dev)]
        moved = [tmesh.refresh_geometry(mm, verts) for mm in meshes]
        rebuilt = cpt.with_pk_rows(cpt.with_convex_rows(tmesh.host_to_device(
            tmesh.from_arrays_host(verts, host["tets"], tet_vel=host["tet_vel"],
                                   vert_vel=host["vert_vel"], dtype=np.float64), cpu)))
        card_cpu = max(float((getattr(moved[1], k).cpu() - getattr(moved[0], k)).abs().max())
                       for k in keys)
        cpu_rebuild = max(float((getattr(moved[0], k) - getattr(rebuilt, k)).abs().max())
                          for k in keys)
        same_topology = bool(torch.equal(moved[1].tet_nbr.cpu(), rebuilt.tet_nbr))
        log(f"[dyn-refresh] {gpu_line} | {name} on a {nside}^3 cube ({host['n_tets']} tets, "
            f"float64): card_vs_cpu_max_abs={card_cpu:.3e} cpu_vs_rebuild_max_abs="
            f"{cpu_rebuild:.3e} topology_unchanged={int(same_topology)} "
            f"max_point_shift={float(np.abs(verts - host['points']).max()):.4f}")
        need(card_cpu <= 1e-12 and cpu_rebuild <= 1e-12 and same_topology,
             f"refresh_geometry ({name}) differs from the CPU or from a rebuild")

    # the kernels on the refreshed (rotated) float32 mesh
    host32, _, _ = tet_payload_of(case, np.float32)
    mesh = tmesh.refresh_geometry(tmesh.host_to_device(host32, dev), verts_rot)
    # a solid-body swirl about the rotated cube's axis, at the tet centroids
    cen = mesh.points[mesh.tets.long()].mean(dim=1)
    axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev).expand_as(cen)
    mesh = cpt.replace_velocity(mesh, tet_vel=2.0 * torch.linalg.cross(axis, cen - 0.5))
    # seeds inside the cube, rotated with it (none falls outside the mesh)
    rng = np.random.default_rng(11)
    rot, t_rot = motions[0][1], motions[0][2]
    pos = torch.as_tensor(rot.transform(rng.uniform(0.02, 0.98, (n, 3)), t_rot),
                          dtype=torch.float32, device=dev)
    tet = cpt.locate_seeds(mesh, cpt.build_grid_locator(mesh), pos)
    need(bool((tet >= 0).all()), "a seed in the rotated cube was not located")
    n_in = n
    vel = torch.as_tensor(rng.normal(size=(n_in, 3)), dtype=torch.float32, device=dev)
    act = torch.ones(n_in, dtype=torch.bool, device=dev)
    xi = torch.as_tensor(rng.standard_normal((n_in, 3)), dtype=torch.float32, device=dev)
    cfg = cpt.StepConfig(dt=0.02, diffusion_coeff=5e-3, inline_hops=1)
    sa, ra = stream_args(cfg, cfg.dt, torch.float32, fused), rare_args(cfg)
    for nn in (n, n - RAGGED):
        m0 = fused.pack_state(fused.row_table(mesh), pos[:nn], vel[:nn], tet[:nn], act[:nn])
        mk, mp = m0.clone(), m0.clone()
        pk = torch.empty(nn, dtype=torch.uint8, device=dev)
        pp = torch.empty_like(pk)
        fused_cuda.stream_cycle(mesh.tet_row, mk, xi[:nn], pk, **sa)
        fused.stream_plain(mesh.tet_row, mp, xi[:nn], pp, **sa)
        same_s, err_s = compare(torch, mk, mp, pk, pp)
        fused_cuda.rare_resolve(mesh.tet_row, mk, pk, mesh.bd_escape, **ra)
        fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **ra)
        same_r, err_r = compare(torch, mk, mp)
        same_r = same_r and bitwise_equal(torch, mk, mp)
        log(f"[dyn-kernels] {gpu_line} | refreshed (rotated) {nside}^3 cube, float32, lanes={nn} "
            f"pending={int(pp.sum())} stream_identical={int(same_s)} stream_max_abs_err="
            f"{err_s:.3e} rare_identical={int(same_r)} rare_max_abs_err={err_r:.3e}")
        need(int(pp.sum()) > 0, "the refreshed-mesh case has no pending lanes")
        need(same_s and err_s <= POS_TOL_F32, f"stream_kernel != stream_plain on the refreshed "
             f"mesh (lanes={nn})")
        need(same_r and err_r <= POS_TOL_F32, f"rare_kernel != rare_plain on the refreshed mesh "
             f"(lanes={nn})")
        errs["stream"] = max(errs["stream"], err_s)
        errs["rare"] = max(errs["rare"], err_r)

    # the oscillating box through the kernels, card against CPU
    box = common.make_oscillating_case(os.path.join(tmp, "osc"), n_particles=2000)
    noise = np.random.default_rng(12).standard_normal((64, 2000, 3))
    draw = fused._brownian_noise
    runs = {}
    try:
        for d in (cpu, dev):
            fused._brownian_noise = (lambda seed, step, nn, dtype, device, mode="threefry":
                                     torch.as_tensor(noise[step], dtype=dtype, device=device))
            for name in COUNTED:
                getattr(fused_cuda, name).launches = 0
            t0 = time.perf_counter()
            case_, st, stats = coupled.run_coupled(box, n_steps=5, dtype=np.float64,
                                                   flow_dtype=torch.float64,
                                                   write_output=False, device=d,
                                                   log=lambda *a: None)
            got = {name: getattr(fused_cuda, name).launches for name in COUNTED}
            runs[d.type] = (case_, st, stats, got, time.perf_counter() - t0)
    finally:
        fused._brownian_noise = draw
    (ccase, cst, cstats, _, _), (kcase, kst, kstats, got, secs) = runs["cpu"], runs[dev.type]
    err = float((kst.pos.cpu() - cst.pos).abs().max())
    tet_ok = bool(torch.equal(kst.tet_id.cpu(), cst.tet_id))
    act_ok = bool(torch.equal(kst.active.cpu(), cst.active))
    shift = float(kcase.tet_mesh.bounds_lo[0])
    ran = {k: v for k, v in got.items() if v}
    log(f"[dyn-coupled] {gpu_line} | oscillating box (tests/test_dynamicmesh.py), 2000 "
        f"particles, float64, 5 steps, {kstats['cycles']} cycles, card against CPU: "
        f"max_abs_err={err:.3e} tet_exact={int(tet_ok)} active_exact={int(act_ok)} "
        f"active_in_domain={int(kstats['active_in_domain'])} bounds_lo_x={shift:.6f} "
        f"(0.2 sin(6.283 t) = {0.2 * np.sin(6.283 * kstats['time']):.6f}) launches={ran} "
        f"geometry_ms_per_step={[round(s['geometry_ms'], 3) for s in kstats['steps']]} "
        f"run_s={secs:.1f}")
    need(tet_ok and act_ok and err <= POS_TOL_GOLDEN and kstats["active_in_domain"],
         "the oscillating box on the card differs from the CPU run")
    # one pack and one unpack a run_cycles call: the 10 cycles go in 6 calls
    # (a call of 1 cycle at each saveInterval's first step)
    need_launches(dev, got, {"stream_cycle": kstats["cycles"], "rare_resolve": kstats["cycles"],
                             "pack_rows": 6, "unpack_rows": 6}, "oscillating box")


def tjunction_case(torch, dst, rehearse):
    """A copy of the repo's TJunction with the phase's cuts: the particle
    window opened at t = 0 (cut ii; the tutorial opens it at 0.5) and
    saveInterval TJ_SAVE_INTERVAL (cut iii); the rehearsal shrinks it as
    tests/test_coupled_e2e.py does, with 2,000 particles."""
    import shutil

    from cudaparticlesfoam_tpu_torch.io import foamfile

    if rehearse:
        return flow_common(torch).shrink_tjunction(dst, num_particles=2_000,
                                                   save_interval=TJ_SAVE_INTERVAL)
    case = os.path.join(dst, "TJunction")
    shutil.copytree(TJUNC, case)
    path = os.path.join(case, "system", "cudaParticlesDict")
    d = foamfile.read(path)
    d.pop("FoamFile", None)
    d.update(startTime=0.0, saveInterval=TJ_SAVE_INTERVAL)
    foamfile.write(path, d, obj_name="cudaParticlesDict")
    return case


STEP_RE = re.compile(
    r"#coupled: step (\d+) t=(\S+) dt_e=(\S+) cycles=(\d+) flow_ms=([\d.]+) "
    r"flow_host_ms=([\d.]+) cg_iterations=(\[[\d, ]*\]) continuity=(\S+) geometry_ms=([\d.]+) "
    r"refresh_ms=([\d.]+) advect_ms_per_cycle=([\d.]+) advect_issue_ms_per_cycle=([\d.]+) "
    r"frames_s=([\d.]+)")


def phase_tjunction(torch, dev, tmp, rehearse, gpu_line):
    """Phase 11c: the TJunction's Allrun (blockmesh -> coupled) through the
    CLI in subprocesses, float32, at the tutorial's width (248,000 cells,
    2.98M tets, 4e6 particles, dt 1e-4, its seeding box and diffusion
    coefficient, kEpsilon, probes, scalarTransport, the p0 ramps) with three
    cuts: --steps TJ_STEPS, the particle window opened at 0, saveInterval
    TJ_SAVE_INTERVAL.  Prints each Eulerian step's numbers, the init, the
    launches and peak memory the driver logs, checks the frames and that
    every active lane is in the domain.  Returns (case dir, launches,
    numbers)."""
    t_phase = time.perf_counter()
    case = tjunction_case(torch, tmp, rehearse)
    out = os.path.join(tmp, "tj_frames")
    res, mesh_s = cli(["blockmesh", case])
    need(res.returncode == 0, f"TJunction blockmesh failed: {res.stderr[-3000:]}")
    cmd = ["coupled", case, "--steps", str(TJ_STEPS), "--out", out]
    res, secs = cli(cmd + (["--device", "cpu"] if rehearse else []), timeout=1000)
    need(res.returncode == 0, f"the TJunction coupled run failed: {res.stderr[-3000:]}")
    text = res.stdout
    steps = [m.groups() for m in STEP_RE.finditer(text)]
    need(len(steps) == TJ_STEPS, f"the coupled run printed {len(steps)} step lines")
    init = re.search(r"#coupled: init: (.*)", text).group(1)
    tets = re.search(r"#adv: tet mesh: (\d+) tets, (\d+) verts, (\d+) boundary tris "
                     r"\(([\d.]+) ms\)", text)
    dev_line = re.search(r"#coupled: on (.*): kernel launches (\{.*\}); peak device memory "
                         r"([\d.]+) GiB", text)
    domain = re.search(r"#coupled: (\d+) of (\d+) lanes active, every active lane in the "
                       r"domain: (\d)", text)
    frames = sorted(f for f in os.listdir(out) if f.endswith(".vtu"))
    frames_gb = sum(os.path.getsize(os.path.join(out, f)) for f in frames) / 1e9
    cycles = sum(int(s[3]) for s in steps)
    for s in steps:
        log(f"[tj-step] {gpu_line} | step {s[0]} t={s[1]} dt_e={s[2]} cycles={s[3]} "
            f"flow_ms={s[4]} (device) flow_host_ms={s[5]} cg_iterations_per_corrector={s[6]} "
            f"continuity={s[7]} velocity_refresh_ms={s[9]} advect_ms_per_cycle={s[10]} "
            f"(device) advect_issue_ms_per_cycle={s[11]} frames_s={s[12]}")
    launches = json.loads(dev_line.group(2).replace("'", '"')) if dev_line else {}
    phase_s = time.perf_counter() - t_phase
    log(f"[tj-run] {gpu_line} | TJunction Allrun via the CLI: cuts (i) --steps {TJ_STEPS}, "
        f"(ii) particle startTime 0, (iii) saveInterval {TJ_SAVE_INTERVAL}; tets="
        f"{tets.group(1)} init: {init} tet_mesh_ms={tets.group(4)} blockmesh_s={mesh_s:.1f} "
        f"coupled_command_s={secs:.1f} cycles={cycles} frames={len(frames)} ({frames_gb:.2f} GB) "
        f"launches={launches} peak_device_GiB={dev_line.group(3) if dev_line else 'n/a (cpu)'} "
        f"active={domain.group(1)} of {domain.group(2)} all_active_in_domain={domain.group(3)} "
        f"phase_s={phase_s:.1f} (bound {TJ_BOUND_S} s on the card)")
    need(domain.group(3) == "1" and domain.group(1) == domain.group(2),
         "the TJunction run lost lanes or left the domain")
    need(len(frames) >= 2 and frames[0] == "particle_0000.vtu", f"frames {frames}")
    for f in frames:
        os.remove(os.path.join(out, f))
    if dev.type == "cuda":
        need(dev_line is not None, "the coupled run printed no device line")
        particle = {k: v for k, v in launches.items() if k not in AMG_LAUNCH_KEYS}
        need(particle == {"stream_cycle": cycles, "rare_resolve": cycles},
             f"the TJunction run launched {particle}, not one stream and one rare kernel a "
             f"cycle ({cycles} cycles)")
        need(phase_s <= TJ_BOUND_S, f"phase 11c took {phase_s:.0f} s")
    return case, launches, {"cycles": cycles, "steps": steps}


def tjunction_after_step1(torch, dev, case):
    """The TJunction loaded in process (the tet mesh from the CLI run's
    cache), float32, as a ``coupled.CoupledRun`` after Eulerian step 1
    (flow step, function objects, velocity refresh, the interval's cycles):
    its ``case``, ``flow``, ``state``, ``cfg`` (the step config) and
    ``step0`` (the next sub-step's number)."""
    from cudaparticlesfoam_tpu_torch.models import coupled

    run = coupled.CoupledRun(case, write_output=False, log=lambda *a: None, device=dev)
    run.step()
    return run


def short_kernel_name(name):
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0][:80]


def device_kernels(torch, prof):
    """The device activity of a profile by kernel name: {name: (count,
    busy ms)}, copies and fills included, largest busy ms first."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, ms = agg.get(e.name, (0, 0.0))
            agg[e.name] = (c + 1, ms + e.time_range.elapsed_us() / 1e3)
    return dict(sorted(agg.items(), key=lambda kv: -kv[1][1]))


def phase_tjunction_trace(torch, dev, run, tmp, gpu_line):
    """Phase 11c, the run's Advect traced: Eulerian steps 2 and 3 of the
    TJunction in process as run_coupled takes them (flow step, velocity
    refresh, the interval through ``CoupledRun.advance_interval`` with frames
    through the async writer on the run's saveInterval schedule).  For each
    chunk of cycles (one run_cycles call) its cycles, device ms (CUDA
    events) and host ms to issue; for each step's interval, under
    torch.profiler, the device's kernels by name with their count and busy
    ms, copies and fills included, and how much of the busy time the stream
    and rare kernels take."""
    from torch.profiler import ProfilerActivity, profile

    from cudaparticlesfoam_tpu_torch.io import vtu
    from cudaparticlesfoam_tpu_torch.models import coupled

    from cudaparticlesfoam_tpu_torch.ops import fused_cuda

    cuda = dev.type == "cuda"
    out = os.path.join(tmp, "tj_trace_frames")
    chunks = []
    inner = coupled.run_cycles
    tcase, flow = run.case, run.flow

    def traced(mesh, state, cfg_, n_cycles, dt):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        if ev:
            ev[0].record()
        h0 = time.perf_counter()
        res = inner(mesh, state, cfg_, n_cycles, dt)
        host_ms = (time.perf_counter() - h0) * 1e3
        if ev:
            ev[1].record()
        chunks.append((n_cycles, ev, host_ms))
        return res

    writer = vtu.AsyncVTUWriter()
    run.writer, run.out_dir = writer, out
    coupled.run_cycles = traced
    # the lines are printed once the writer's thread, which prints each
    # frame it writes, has finished: a line printed beside it can be split
    held = []
    try:
        for k in (2, 3):
            dt_e = flow.stable_dt(tcase.control)
            flow.advance(dt_e)
            tcase.update_velocity(flow.cell_velocity())
            chunks.clear()
            first = run.step0
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            launched = fused_cuda.stream_cycle.launches
            with profile(activities=acts) as prof:
                if cuda:
                    # the profiler drops the first device events after it
                    # starts: let int16 fills (no Advect op makes one) take them
                    warm = torch.empty(1, dtype=torch.int16, device=dev)
                    for _ in range(WARM_FILLS):
                        warm.fill_(0)
                    torch.cuda.synchronize(dev)
                run.advance_interval(dt_e)
                step0 = run.step0
                if cuda:
                    torch.cuda.synchronize(dev)
            launched = fused_cuda.stream_cycle.launches - launched
            frames = [s for s in range(first, step0) if s % tcase.particles.save_interval == 0]
            rows = [(n_c, ev[0].elapsed_time(ev[1]) if ev else host, host)
                    for n_c, ev, host in chunks]
            cycles = step0 - first
            dev_ms = sum(r[1] for r in rows)
            host_ms = sum(r[2] for r in rows)
            held.append(f"[tj-advect] {gpu_line} | step {k} dt_e={dt_e:g} cycles={cycles} "
                f"frames_at_sub_steps={frames} chunks(cycles, device_ms, issue_ms)="
                f"{[(n_c, round(d, 4), round(h, 4)) for n_c, d, h in rows]} "
                f"advect_ms_per_cycle={dev_ms / cycles:.4f} (device, the chunks' events) "
                f"advect_issue_ms_per_cycle={host_ms / cycles:.4f}")
            if not cuda:
                held.append(f"[tj-advect] step {k} device kernels: not measured (CPU)")
                continue
            kern = device_kernels(torch, prof)
            kern = {n: v for n, v in kern.items() if "FillFunctor<short>" not in n}
            busy = sum(ms for _, ms in kern.values())
            ours = {n: v for n, v in kern.items() if "stream_kernel" in n or "rare_kernel" in n}
            seen = sum(c for n, (c, _) in ours.items() if "stream_kernel" in n)
            ours_ms = sum(ms for _, ms in ours.values())
            copies = sum(ms for n, (_, ms) in kern.items() if n.startswith("Memcpy"))
            top = "; ".join(f"{short_kernel_name(n)}: {c} x, {ms:.3f} ms"
                            for n, (c, ms) in list(kern.items())[:12])
            held.append(f"[tj-advect] {gpu_line} | step {k} the interval's device activity: "
                f"stream_kernels_profiled={seen} of {launched} launched busy_ms={busy:.3f} "
                f"stream_and_rare_kernels_ms={ours_ms:.3f} copies_ms={copies:.3f} "
                f"other_kernels_ms={busy - ours_ms - copies:.3f} kinds={len(kern)} | {top}")
    finally:
        coupled.run_cycles = inner
        run.writer = None
        writer.close()
    for line in held:
        log(line)
    for f in os.listdir(out) if os.path.isdir(out) else ():
        os.remove(os.path.join(out, f))


def phase_tjunction_cycle(torch, fused, fused_cuda, dev, tcase, st, cfg, errs, counts, rares,
                          gpu_line, tag="tjunction", label="tj-cycle"):
    """Phase 11c (and 13c with ``tag="tjunction_par"``), the kernels at the
    TJunction's shape: from the state after step 1, one cycle through
    stream_kernel and rare_kernel against their plain versions
    (tet/active/pending identical, pos/vel within 1e-5), the hop and pending
    shares, each kernel's device time (graph replay) and its plain
    version's, for phase 6's bounds and latency rows (keys stream_<tag>,
    rare_<tag>)."""
    mesh, n, dt = tcase.tet_mesh, st.n_particles, cfg.dt
    m0 = fused.pack_state(fused.row_table(mesh), st.pos, st.vel, st.tet_id, st.active)
    xi = fused._brownian_noise(st.seed, st.step, n, m0.dtype, dev)
    sa, ra = stream_args(cfg, dt, m0.dtype, fused), rare_args(cfg)
    mk, mp = m0.clone(), m0.clone()
    pk = torch.empty(n, dtype=torch.uint8, device=dev)
    pp = torch.empty_like(pk)
    fused_cuda.stream_cycle(mesh.tet_row, mk, xi, pk, **sa)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **sa)
    same_s, err_s = compare(torch, mk, mp, pk, pp)
    m1, p1 = mp.clone(), pp.clone()
    hops = rows_changed(torch, m0, mk, 20)
    fused_cuda.rare_resolve(mesh.tet_row, mk, pk, mesh.bd_escape, **ra)
    fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **ra)
    same, err = compare(torch, mk, mp)
    pending = int(p1.sum())
    n_el = m0.element_size()
    counts[f"stream_{tag}"] = ("stream", dict(n=n, elem=n_el, noise="xi", hops=hops,
                                                 hopped=hops))
    counts[f"rare_{tag}"] = ("rare", dict(n=n, elem=n_el, pending=pending,
                                             moved=moved(torch, m1, mk)))
    log(f"[{label}] TJunction shape after step 1: lanes={n} tets={mesh.n_tets} "
        f"inline_hops={cfg.inline_hops} inline_bounce={int(cfg.inline_bounce)} "
        f"hop_share={hops / n:.4f} pending={pending} pending_share={pending / n:.5f} "
        f"stream_identical={int(same_s)} stream_max_abs_err={err_s:.3e} "
        f"cycle_identical={int(same)} cycle_max_abs_err={err:.3e}")
    need(same_s and same and max(err, err_s) <= POS_TOL_F32,
         f"the TJunction cycle ({tag}): kernel != plain")
    errs[f"stream_{tag}"], errs[f"rare_{tag}"] = err_s, err
    work, pend = m0.clone(), pk.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)

    timer = Timer(torch, dev)
    times = {}
    for key, fn, plain, restore in (
        (f"stream_{tag}", lambda: fused_cuda.stream_cycle(mesh.tet_row, work, xi, pend, **sa),
         lambda: fused.stream_plain(mesh.tet_row, work, xi, pend, **sa), restore_stream),
        (f"rare_{tag}",
         lambda: fused_cuda.rare_resolve(mesh.tet_row, work, pend, mesh.bd_escape, **ra),
         lambda: fused.rare_plain(mesh.tet_row, work, pend, mesh.bd_escape, **ra),
         restore_rare),
    ):
        times[key] = rare_row(torch, timer, fn, plain, restore)
        t = times[key]
        log(f"[{label}] {gpu_line} | {key}_kernel_ms={t[0]:.5f} (device: {BATCH} calls "
            f"replayed from a graph, restore subtracted) one_call_at_a_time_ms=({t[2][1]:.4f}, "
            f"{t[2][2]:.4f}) {key}_plain_ms={t[1]:.4f} ({t[2][0]:.4f}, {t[2][3]:.4f}) lanes={n}")
    rares.add(f"rare_{tag}", bary_rare_case(torch, fused, fused_cuda, mesh.tet_row, mesh, m1,
                                               p1, ra, fused.LAYOUT_TET, "cpf_rare_f32"))
    return times


def phase_pimple_split(torch, dev, tcase, flow, gpu_line):
    """Phase 11d: one PIMPLE step on the TJunction, float32, at the state
    after step 1, split into its stages (the package's own stage
    functions, in pimple_step's order): momentum predictor, each PISO
    corrector's pressure system / pressure solve (AMG-CG) / correction, the
    kEpsilon step and the Courant number; each part's device ms, the host's
    ms to issue it, its kernels and launch calls (torch.profiler) and the
    kernels' busy ms.  Item F's PIMPLE workload."""
    from cudaparticlesfoam_tpu_torch.models import pimple, turbulence

    m, cfg, st = flow.m, flow.cfg, flow.state
    dt_e = flow.stable_dt(tcase.control)
    ddt = m.vol / torch.as_tensor(dt_e, dtype=m.dtype, device=m.device)
    kes = flow.kes
    nut_bd = turbulence.wall_nut_bd(m, flow.wi, kes.nut, kes.k, cfg.nu)
    nu_f = pimple.face_viscosity(m, cfg, kes.nut, nut_bd)
    mo = pimple.momentum_predictor(m, st, flow.u_bcs, flow.p_bcs, cfg, ddt, st.u, nu_f)
    parts = {"momentum predictor": lambda: pimple.momentum_predictor(
        m, st, flow.u_bcs, flow.p_bcs, cfg, ddt, st.u, nu_f)}
    p, u_corr, its = st.p, mo.u_star, []
    for c in range(cfg.n_correctors):
        hbya, phi_hbya, rhs = pimple.pressure_system(m, mo, u_corr)
        p_in = p
        p, corr, _, it = pimple.pressure_solve(m, mo, rhs, p_in, flow.p_bcs, cfg, flow.amg)
        its += it
        parts[f"corrector {c + 1}: pressure system"] = (
            lambda u=u_corr: pimple.pressure_system(m, mo, u))
        parts[f"corrector {c + 1}: pressure solve (AMG-CG, {it} iterations)"] = (
            lambda r=rhs, q=p_in: pimple.pressure_solve(m, mo, r, q, flow.p_bcs, cfg, flow.amg))
        parts[f"corrector {c + 1}: correction"] = (
            lambda h=hbya, f=phi_hbya, q=p, k=corr: pimple.correct(m, mo.rau, mo.rau_f, h, f, q, k,
                                                                    flow.p_bcs))
        flux, u_corr, _ = pimple.correct(m, mo.rau, mo.rau_f, hbya, phi_hbya, p, corr,
                                         flow.p_bcs)
    new_u, new_flux = u_corr, flux
    parts[f"{flow.turb_model} step"] = lambda: turbulence.model_step(
        flow.turb_model, m, kes, new_u, flow.u_bcs, new_flux, flow.k_bcs, flow.e_bcs, flow.wi,
        cfg.nu, dt=dt_e)
    parts["Courant number (stable_dt)"] = lambda: flow.stable_dt(tcase.control)

    def whole():
        s, _ = pimple.pimple_step(m, st, flow.u_bcs, flow.p_bcs, cfg, dt_e, nut=kes.nut,
                                  amg=flow.amg, nut_bd=nut_bd)
        turbulence.model_step(flow.turb_model, m, kes, s.u, flow.u_bcs, s.flux, flow.k_bcs,
                              flow.e_bcs, flow.wi, cfg.nu, dt=dt_e)
        return flow.stable_dt(tcase.control)

    out = {}
    for name, fn in [("whole step", whole)] + list(parts.items()) + [("whole step, again",
                                                                      whole)]:
        r = measure_part(torch, dev, fn, reps=WHOLE_REPS if name.startswith("whole") else 3)
        out[name] = r
        log(f"[pimple-split] {gpu_line} | TJunction at t={flow.time:g}, {m.n_cells} cells, "
            f"float32, {name}: ms={r['ms']:.4f} host_issue_ms={r['host_ms']:.4f} "
            f"kernels={unmeasured(r['kernels'])} launch_calls={unmeasured(r['launch_calls'])} "
            f"kernel_busy_ms={unmeasured(r['busy_ms'], '%.4f')}")
    first, again = out["whole step"], out["whole step, again"]
    sum_ms = sum(out[k]["ms"] for k in parts)
    # the whole step's spread: every timed sample of both runs, and the idle
    # share at the fastest, the median and the slowest of them (the kernels'
    # busy ms of the profiled call of each run)
    samples = sorted(first["samples_ms"] + again["samples_ms"])
    med = float(np.median(samples))
    if first["busy_ms"] is not None:
        busy = (first["busy_ms"] + again["busy_ms"]) / 2
        idle = "%.3f (at the median; %.3f at the fastest, %.3f at the slowest)" % (
            1.0 - busy / med, 1.0 - busy / samples[0], 1.0 - busy / samples[-1])
    else:
        idle = "not measured"
    log(f"[pimple-split] {gpu_line} | one PIMPLE step (+ {flow.turb_model}, Courant): "
        f"parts_sum_ms={sum_ms:.4f} whole_ms={med:.4f} (median of {len(samples)}) "
        f"whole_ms_min_max=({samples[0]:.4f}, {samples[-1]:.4f}) "
        f"whole_ms_samples={[round(x, 4) for x in samples]} "
        f"kernels_per_step={first['kernels']} launch_calls_per_step={first['launch_calls']} "
        f"device_idle_share={idle} cg_iterations={its}")
    need(all(i > 0 for i in its) and all(np.isfinite(r["ms"]) for r in out.values()),
         "the PIMPLE split did not run")
    return dict(m=m, h=flow.amg, A=mo.Ap, b=rhs, x0=p_in, tol=cfg.p_tol, max_iter=cfg.p_max_iter,
                whole=whole)


# ---------------------------------------------------------------------------
# phase 12: the multi-device particle strategies (parallel/{sharding,auto,
# partition}.py) and rare_kernel<T, L, kRemote>, the partitioned shard's rare
# stage
# ---------------------------------------------------------------------------

PART_SHARDS = 4           # 12a's slabs, 12b's and 12c's shards
PART_SLACK = 1.25         # bench.py:261-297's partitioned-1shard
PART_CAP_OUT = 0.125
PART_PATH = "north-star, partitioned"
DP_PATH = "north-star, DP 4 shards"
DRIVER_TOL = 1e-9         # 12c, float64
POS_TOL_PART = 1e-5       # 12b against the single-device "rbg" run, float32


def remote_case(torch, fused, pm, s, n, dtype, ly, seed, dev):
    """Shard ``s``'s mega of ``n`` lanes on random tets of its slab, each at
    its tet's centroid plus a kick of about two cells (arrivals to settle:
    many outside their tet, some past a wall or in another slab), random
    velocities, 2% inactive."""
    rng = np.random.default_rng(seed)
    per = pm.tets_per_shard
    tab = pm.tet_row[s]
    tl = torch.as_tensor(rng.integers(0, per, n), device=dev)
    rows = tab[tl].double()
    a, tinv = rows[:, 0:3], rows[:, 3:12].reshape(n, 3, 3)
    cen = a + torch.linalg.solve(tinv, torch.full((n, 3), 0.25, dtype=torch.float64,
                                                  device=dev))
    pos = cen + torch.as_tensor(rng.normal(scale=2.0, size=(n, 3)), device=dev)
    m = torch.zeros((n, ly.width), dtype=dtype, device=dev)
    m[:, 0:3] = pos.to(dtype)
    m[:, 3:6] = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev)
    m[:, 6] = tl.to(dtype)
    m[:, 7] = torch.as_tensor(rng.uniform(size=n) > 0.02, dtype=dtype, device=dev)
    m[:, 8:8 + tab.shape[1]] = tab[tl]
    return m


def pause_counts(torch, m_in, m_out, per):
    """(lanes paused by the walk, lanes paused after a bounce): a paused
    lane holds the sentinel tet below -per; a bounce changed its velocity."""
    paused = m_out[:, 6] < -per
    bounced = (m_out[:, 3:6] != m_in[:, 3:6]).any(dim=1)
    return int((paused & ~bounced).sum()), int((paused & bounced).sum())


def phase_remote_parity(torch, cpt, fused, fused_cuda, tmesh, convert, partition, dev, nside,
                        n, errs, rehearse):
    """Phase 12a: rare_kernel<T, L, kRemote> against rare_plain(remote=) on
    a box partitioned into 4 slabs: the settle call and the cycle call
    (after stream_kernel with bounce_on=False, esc_on=False, as the shard
    cycle runs it) on shard 1, TET and PK, float32 and float64, both lane
    counts, the six pending patterns; bit for bit, one launch a call,
    lanes pausing by the walk and by a bounce."""
    patterns = PATTERNS[:2] if rehearse else PATTERNS
    n = n // 3 if rehearse else n
    t0 = time.perf_counter()
    for dtype, layout in itertools.product((torch.float32, torch.float64), ("tet", "pk")):
        npdt = np.float32 if dtype == torch.float32 else np.float64
        mesh = convert.to_mesh(box_payload(tmesh, nside, npdt, swirl(nside)), dev)
        if layout == "pk":
            mesh = cpt.with_pk_rows(mesh)
        ly = fused.LAYOUT_PK if layout == "pk" else fused.LAYOUT_TET
        pm = partition.partition_mesh(mesh, PART_SHARDS, layout=layout)
        s, per = 1, pm.tets_per_shard
        tab, esc = pm.tet_row[s], pm.bd_escape[s]
        ra = dict(max_hops=50, max_bounces=10, reflect_wall=True, ly=ly,
                  remote=(esc.shape[0], per))
        cfg = cpt.StepConfig(dt=0.9, diffusion_coeff=5e-3, inline_hops=4,
                             velocity_interp="VertexVelocity" if layout == "pk"
                             else "TetVelocity")
        sa = dict(stream_args(cfg, cfg.dt, dtype, fused), bounce_on=False, esc_on=False, ly=ly)
        key = f"rare_{'pk_' if layout == 'pk' else ''}remote"
        for nn in (n, n - RAGGED):
            m0 = remote_case(torch, fused, pm, s, nn, dtype, ly, nn + per, dev)
            xi = torch.as_tensor(np.random.default_rng(nn).standard_normal((nn, 3)), dtype=dtype,
                                 device=dev)
            walk = bounce = 0
            for call in ("settle", "cycle"):
                m = m0.clone()
                if call == "settle":
                    pend = partition.settle_flags(m).to(torch.uint8)
                else:
                    pend = torch.empty(nn, dtype=torch.uint8, device=dev)
                    fused_cuda.stream_cycle(tab, m, xi, pend, **sa)
                mk, mp = m.clone(), m.clone()
                fused_cuda.rare_resolve(tab, mk, pend, esc, **ra)
                fused.rare_plain(tab, mp, pend, esc, **ra)
                same, err = compare(torch, mk, mp)
                need(same and bitwise_equal(torch, mk, mp),
                     f"rare_kernel<{layout}, remote> != rare_plain ({call}, lanes={nn}, {dtype})")
                w, b = pause_counts(torch, m, mp, per)
                walk, bounce = walk + w, bounce + b
                tag = f"rare_kernel<{layout}, remote> ({call}, lanes={nn}, {dtype})"
                rare_patterns(torch, fused_cuda.rare_resolve,
                              lambda mm, q: fused_cuda.rare_resolve(tab, mm, q, esc, **ra),
                              lambda mm, q: fused.rare_plain(tab, mm, q, esc, **ra), m, pend, tag,
                              patterns)
                errs[key] = max(errs[key], err)
                log(f"[remote] layout={layout} dtype={str(dtype)[6:]} lanes={nn} call={call} "
                    f"pending={int(pend.sum())} paused_by_walk={w} paused_after_bounce={b} "
                    f"identical=1 max_abs_err={err:.3e} patterns_identical=1 "
                    f"({','.join(patterns)})")
            need(walk > 0 and bounce > 0,
                 f"rare_kernel<{layout}, remote> (lanes={nn}, {dtype}): {walk} lanes paused by "
                 f"the walk, {bounce} after a bounce; both must be > 0")
    log(f"[remote] 12a done in {time.perf_counter() - t0:.1f} s")


def engine_counts(fused_cuda):
    out = {name: getattr(fused_cuda, name).launches for name in COUNTED}
    out["rare_resolve_remote"] = fused_cuda.rare_resolve.remote_launches
    return {k: v for k, v in out.items() if v}


def reset_counts(fused_cuda):
    for name in COUNTED:
        getattr(fused_cuda, name).launches = 0
    fused_cuda.rare_resolve.remote_launches = 0


def profile_engine(torch, dev, eng, dt, n=20):
    """(the device's busy ms a cycle, kernels and copies included, and the
    eight busiest device activities with their count and ms a cycle) of
    ``n`` cycles of ``eng.advance`` under torch.profiler; None on the CPU."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.advance(n, dt)
        torch.cuda.synchronize(dev)
    agg = device_kernels(torch, prof)
    busy = sum(ms for _, ms in agg.values()) / n
    top = {short_kernel_name(k): (c / n, round(ms / n, 4)) for k, (c, ms) in list(agg.items())[:8]}
    return busy, top


def timed_engine(torch, fused_cuda, dev, eng, dt, n_cycles, warm):
    """(ms/cycle of 3 runs, host issue ms/cycle of each, launches by wrapper
    of the 3 runs, the partitioned engine's settle rounds in them, peak
    bytes, the device's busy ms a cycle and its busiest activities in a
    profiled 20-cycle run) of ``eng.advance``, after ``warm`` cycles; the
    counts are set to 0 just before the timed runs."""
    eng.advance(warm, dt)
    timer = Timer(torch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(fused_cuda)
    rounds0 = getattr(eng, "_settle_rounds", 0)
    ms, host = [], []
    for _ in range(3):
        timer.start()
        h0 = time.perf_counter()
        eng.advance(n_cycles, dt)
        host.append((time.perf_counter() - h0) * 1e3 / n_cycles)
        ms.append(timer.stop() / n_cycles)
    launches = engine_counts(fused_cuda)
    rounds = getattr(eng, "_settle_rounds", 0) - rounds0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return (ms, host, launches, rounds, peak) + profile_engine(torch, dev, eng, dt)


def idle_share(busy, ms):
    return None if busy is None else 1.0 - busy / float(np.median(ms))


def same_state(torch, a, b):
    return all(bitwise_equal(torch, getattr(a, f), getattr(b, f)) for f in ("pos", "vel")) and \
        bool(torch.equal(a.tet_id, b.tet_id) and torch.equal(a.active, b.active))


def shard_cycle_times(torch, fused, fused_cuda, timer, run, xi, cfg, dt, errs):
    """Device ms of stream_kernel and rare_kernel, and their plain
    versions', on one data-parallel shard's packed state (its next cycle,
    noise ``xi``), each held against its plain version (``errs``), with
    the counts for their bounds."""
    mesh, m0, n = run.mesh, run.m.clone(), run.m.shape[0]
    sa = stream_args(cfg, dt, m0.dtype, fused)
    ra = rare_args(cfg)
    pk = torch.empty(n, dtype=torch.uint8, device=m0.device)
    pp = torch.empty_like(pk)
    m1, mp = m0.clone(), m0.clone()
    fused_cuda.stream_cycle(mesh.tet_row, m1, xi, pk, **sa)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **sa)
    same_s, err_s = compare(torch, m1, mp, pk, pp)
    p1 = pk.clone()
    hops = rows_changed(torch, m0, m1, 20)
    mr, mrp = m1.clone(), m1.clone()
    fused_cuda.rare_resolve(mesh.tet_row, mr, p1, mesh.bd_escape, **ra)
    fused.rare_plain(mesh.tet_row, mrp, p1, mesh.bd_escape, **ra)
    same_r, err_r = compare(torch, mr, mrp)
    need(same_s and err_s <= POS_TOL_F32 and same_r and bitwise_equal(torch, mr, mrp),
         "a data-parallel shard's kernels != their plain versions")
    errs["stream_dp"] = max(errs["stream_dp"], err_s)
    errs["rare_dp"] = max(errs["rare_dp"], err_r)
    work, pend = m0.clone(), pk.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)

    times = {"stream_dp": kernel_vs_plain_ms(
        timer, lambda: fused_cuda.stream_cycle(mesh.tet_row, work, xi, pend, **sa),
        lambda: fused.stream_plain(mesh.tet_row, work, xi, pend, **sa), restore_stream),
        "rare_dp": rare_row(
        torch, timer, lambda: fused_cuda.rare_resolve(mesh.tet_row, work, pend, mesh.bd_escape,
                                                      **ra),
        lambda: fused.rare_plain(mesh.tet_row, work, pend, mesh.bd_escape, **ra), restore_rare)}
    el = m0.element_size()
    counts = {"stream_dp": ("stream", dict(n=n, elem=el, noise="xi", hops=hops, hopped=hops)),
              "rare_dp": ("rare", dict(n=n, elem=el, pending=int(p1.sum()),
                                       moved=moved(torch, m1, mr)))}
    case = bary_rare_case(torch, fused, fused_cuda, mesh.tet_row, mesh, m1, p1, ra,
                          fused.LAYOUT_TET, "cpf_rare_f32")
    return times, counts, case


def phase_dp(torch, cpt, fused, fused_cuda, sharding, auto, dev, slice_setup, n_cycles, warm,
             gate, errs, counts, rares, gpu_line):
    """Phase 12b, part 1: particle data parallelism with 4 shards on the
    north-star slice, under threefry and under rbg_kernel: ``warm`` cycles,
    3 x ``n_cycles`` timed, and a ``gate``-cycle run against its
    single-device reference."""
    mesh, st0, n_in, bcfg = slice_setup
    times, launches = {}, {}
    for mode in ("threefry", "rbg_kernel"):
        cfg = dataclasses.replace(bcfg, brownian_rng=mode)
        eng = auto.ParticleEngine(mesh, st0, cfg, devices=PART_SHARDS, strategy="dp", log=log)
        ms, host, la, _, peak, busy, top = timed_engine(torch, fused_cuda, dev, eng, cfg.dt,
                                                        n_cycles, warm)
        st = eng.snapshot()
        med = float(np.median(ms))
        log(f"[dp] {gpu_line} | brownian_rng={mode} shards={PART_SHARDS} "
            f"placement=[{sharding.placement(eng.devices)}] ms_per_cycle="
            f"{['%.4f' % x for x in ms]} median={med:.4f} particle_steps_per_s="
            f"{st0.n_particles / (med * 1e-3):.4e} host_issue_ms_per_cycle="
            f"{['%.4f' % x for x in host]} launches={la} max_memory_allocated={peak} "
            f"device_busy_ms_per_cycle={unmeasured(busy, '%.4f')} idle_share="
            f"{unmeasured(idle_share(busy, ms), '%.3f')} busiest_per_cycle={top}")
        domain_check(torch, cpt, mesh, st, n_in, f"dp-{mode}")
        if dev.type == "cuda":
            want = 3 * n_cycles * PART_SHARDS
            need(la.get("stream_cycle") == want and la.get("rare_resolve") == want,
                 f"dp {mode}: launches {la}, not {want} stream and rare")
        if mode == "threefry":
            launches = {"stream_dp": la.get("stream_cycle", 0),
                        "rare_dp": la.get("rare_resolve", 0)}
            # one shard's kernels at this path's shape, on its real next cycle
            run = eng._dp.runs[0]
            xi = fused._brownian_noise(run.seed, run.step, eng._dp.n_total, run.m.dtype,
                                       dev)[:run.m.shape[0]].contiguous()
            t, c, case = shard_cycle_times(torch, fused, fused_cuda, Timer(torch, dev), run, xi,
                                           cfg, cfg.dt, errs)
            times.update(t)
            counts.update(c)
            rares.add("rare_dp", case)
            log(f"[dp] {gpu_line} | one shard ({run.m.shape[0]} lanes): stream_kernel_ms="
                f"{t['stream_dp'][0]:.4f} plain_ms={t['stream_dp'][1]:.4f} rare_kernel_ms="
                f"{t['rare_dp'][0]:.5f} (graph replay) plain_ms={t['rare_dp'][1]:.4f} "
                f"pending={c['rare_dp'][1]['pending']}")
        del eng
        # the gate: threefry = the single-device run of the padded state; under
        # rbg_kernel each shard = a single-device run of its slice with its offset
        eng = auto.ParticleEngine(mesh, st0, cfg, devices=PART_SHARDS, strategy="dp",
                                  log=lambda *a: None)
        eng.advance(gate, cfg.dt)
        got = eng._dp.states()
        if mode == "threefry":
            ref = cpt.run_cycles(mesh, sharding.pad_particles(st0, PART_SHARDS), cfg,
                                 gate)
            ok = same_state(torch, type("St", (), {f: torch.cat([getattr(g, f) for g in got])
                                                   for f in ("pos", "vel", "tet_id",
                                                             "active")}), ref)
        else:
            n_pad = got[0].n_particles + (-got[0].n_particles) % fused._PACK_LANES
            shards = sharding.shard_state(st0, eng.devices)
            ok = all(same_state(torch, g, cpt.run_cycles(mesh, sh, cfg, gate,
                                                         lane_offset0=s * n_pad))
                     for s, (g, sh) in enumerate(zip(got, shards)))
        log(f"[dp] brownian_rng={mode} {gate} cycles: "
            + ("= the single-device run of the padded state" if mode == "threefry" else
               "each shard = a single-device run of its slice with lane offset s * n_pad")
            + f", bit for bit: {int(ok)}")
        need(ok, f"dp {mode} differs from its single-device reference")
        del eng, got
    return launches, times


def remote_cycle_case(torch, fused, fused_cuda, partition, mega, s, dt):
    """Shard ``s``'s second rare call of its next cycle, as
    MegaShards.cycles makes it: (mega after the settle call and the stream
    kernel, its pending flags, the context)."""
    ctx = mega.ctxs[s]
    m = mega.m[s].clone()
    pend = torch.empty(m.shape[0], dtype=torch.uint8, device=m.device)
    noise = partition._pid_noise(mega.seed, mega.step, mega.pid[s], mega.cfg, m.dtype)
    partition._settle(ctx, m, pend)
    fused_cuda.stream_cycle(ctx.tab, m, noise if mega.cfg.use_brownian else None, pend,
                            bounce_on=False, esc_on=False, n_hops=ctx.cfg.inline_hops,
                            ly=ctx.ly, **fused.stream_kwargs(ctx.cfg, dt, m.dtype))
    return m, pend, ctx


def remote_times(torch, fused, fused_cuda, partition, mega, dt, key, layout, counts, rares,
                 errs):
    """rare_kernel<remote>'s device ms against rare_plain(remote=) on shard
    1's real second call of the next cycle, with its counts and rare study."""
    m1, p1, ctx = remote_cycle_case(torch, fused, fused_cuda, partition, mega, 1, dt)
    work, pend = m1.clone(), p1.clone()

    def restore():
        work.copy_(m1)
        pend.copy_(p1)

    t = rare_row(torch, Timer(torch, m1.device),
                 lambda: fused_cuda.rare_resolve(ctx.tab, work, pend, ctx.bd_esc, **ctx.rare),
                 lambda: fused.rare_plain(ctx.tab, work, pend, ctx.bd_esc, **ctx.rare), restore)
    mk, mp = m1.clone(), m1.clone()
    fused_cuda.rare_resolve(ctx.tab, mk, p1, ctx.bd_esc, **ctx.rare)
    fused.rare_plain(ctx.tab, mp, p1, ctx.bd_esc, **ctx.rare)
    same, err = compare(torch, mk, mp)
    need(same and bitwise_equal(torch, mk, mp), f"{key} != rare_plain(remote=) at the path's shape")
    errs[key] = max(errs[key], err)
    counts[key] = ("rare", dict(n=m1.shape[0], elem=m1.element_size(), pending=int(p1.sum()),
                                moved=moved(torch, m1, mk), layout=layout))
    rem = dict(ctx.rare)
    rares.add(key, RareCase(
        m1, p1, None, fused.rare_chain(ctx.tab, m1, p1, ctx.bd_esc, **rem),
        lambda m, p, d: fused_cuda.rare_resolve(ctx.tab, m, p, ctx.bd_esc, **rem), None, None))
    return t, int(p1.sum()), pause_counts(torch, m1, mp, mega.pm.tets_per_shard)


class PartitionedRun:
    """The partitioned strategy at bench.py's partitioned-1shard settings
    (slack 1.25, cap_out_frac 0.125, ``bench.py:261-297``), driven through
    parallel/partition.py: partition_mesh, distribute_particles(slack=),
    shard_arrays, and the resident MegaShards (cap_out_frac=) across
    ``advance`` calls, as ParticleEngine keeps them; ``snapshot`` settles
    and collects as the engine does."""

    def __init__(self, torch, cpt, partition, sharding, mesh, st, cfg, S, layout):
        self.torch, self.cpt, self.partition, self.cfg = torch, cpt, partition, cfg
        self.n, self.device, self.dtype = st.n_particles, st.device, st.dtype
        self.devices = sharding.make_device_mesh(S, st.device)
        pm = partition.partition_mesh(mesh, S, layout=layout)
        sp = partition.distribute_particles(pm, st.pos, st.vel, st.tet_id, st.active,
                                            seed=st.seed, slack=PART_SLACK, step=st.step)
        self.pm, sp = partition.shard_arrays(pm, sp, self.devices)
        self.capacity = sp.capacity
        self._mega = partition.MegaShards(self.pm, cfg, self.devices, sp, PART_CAP_OUT)
        self.migrated = self.deferred = self._settle_rounds = 0

    def advance(self, n_cycles, dt):
        stats = self._mega.cycles(n_cycles, dt)
        self.migrated = self.migrated + stats["migrated"]
        self.deferred = self.deferred + stats["deferred"]
        self._settle_rounds += stats["settle_rounds"]

    def snapshot(self):
        return settled_state(self.torch, self.cpt, self.partition, self.pm, self.cfg,
                             self.devices, self._mega.decode(), self.n, self.device, self.dtype)


def settled_state(torch, cpt, partition, pm, cfg, devices, sp, n, dev, dtype):
    """The slot arrays ``sp`` after the settle step, gathered into a
    ParticleState in the original order (ParticleEngine.snapshot)."""
    settled, _ = partition.make_settle_step(pm, cfg, devices)(pm, sp, 0.0)
    pos, vel, tet, act = partition.collect_particles(pm, settled, n)
    return cpt.ParticleState(
        pos=torch.as_tensor(pos, dtype=dtype, device=dev),
        vel=torch.as_tensor(vel, dtype=dtype, device=dev),
        disp=torch.zeros((n, 3), dtype=dtype, device=dev),
        tet_id=torch.as_tensor(tet, device=dev), active=torch.as_tensor(act, device=dev),
        seed=sp.seed, step=sp.step)


def phase_partitioned(torch, cpt, fused, fused_cuda, tmesh, partition, sharding, dev, nside,
                      slice_setup, n_cycles, warm, gate, errs, counts, rares, gpu_line):
    """Phase 12b, part 2: the partitioned strategy on the north-star slice
    at bench.py's partitioned-1shard settings, S = 1 then S = 4: the
    resident MegaShards timed (``warm``, 3 x ``n_cycles``), and a
    ``gate``-cycle make_partitioned_runner run against the single-device
    run under "rbg"; then under VertexVelocity at S = 4 (the Pk remote
    kernel's run)."""
    mesh, st0, n_in, bcfg = slice_setup
    n = st0.n_particles
    times, launches = {}, {}
    rbg = dataclasses.replace(bcfg, brownian_rng="rbg")
    ref = cpt.run_cycles(mesh, st0, rbg, gate)
    for S in (1, PART_SHARDS):
        t0 = time.perf_counter()
        eng = PartitionedRun(torch, cpt, partition, sharding, mesh, st0, bcfg, S, "tet")
        setup_s = time.perf_counter() - t0
        ms, host, la, rounds, peak, busy, top = timed_engine(torch, fused_cuda, dev, eng,
                                                             bcfg.dt, n_cycles, warm)
        n_run = 3 * n_cycles + warm + (20 if dev.type == "cuda" else 0)
        per_cycle = {k: v / (3 * n_cycles) for k, v in la.items()}
        resident = sum(int(r.sum()) for r in eng._mega.res)
        st = eng.snapshot()
        med = float(np.median(ms))
        log(f"[part] {gpu_line} | shards={S} placement=[{sharding.placement(eng.devices)}] "
            f"capacity={eng.capacity} slack={PART_SLACK} cap_out_frac={PART_CAP_OUT} "
            f"setup_s={setup_s:.2f} ms_per_cycle={['%.4f' % x for x in ms]} median={med:.4f} "
            f"particle_steps_per_s={n / (med * 1e-3):.4e} host_issue_ms_per_cycle="
            f"{['%.4f' % x for x in host]} launches_per_cycle={per_cycle} "
            f"migrated_per_cycle={int(eng.migrated) / n_run:.1f} "
            f"deferred_per_cycle={int(eng.deferred) / n_run:.1f} "
            f"settle_rounds_per_cycle={rounds / (3 * n_cycles):.3f} "
            f"max_memory_allocated={peak} device_busy_ms_per_cycle={unmeasured(busy, '%.4f')} "
            f"idle_share={unmeasured(idle_share(busy, ms), '%.3f')} resident={resident} "
            f"busiest_per_cycle={top}")
        need(resident == n, f"partitioned S={S}: {resident} lanes resident, not {n}")
        domain_check(torch, cpt, mesh, st, n_in, f"part-{S}")
        if dev.type == "cuda":
            # a settle and a cycle call a shard each cycle, one more settle a round
            need(la.get("stream_cycle") == 3 * n_cycles * S
                 and la.get("rare_resolve_remote") == (2 * 3 * n_cycles + rounds) * S,
                 f"partitioned S={S}: launches {la}, settle rounds {rounds}")
        if S == PART_SHARDS:
            launches["rare_remote"] = la.get("rare_resolve_remote", 0)
            t, pend, (w, b) = remote_times(torch, fused, fused_cuda, partition, eng._mega,
                                           bcfg.dt, "rare_remote", "tet", counts, rares, errs)
            times["rare_remote"] = t
            log(f"[part] {gpu_line} | rare_kernel<remote> on shard 1's second call "
                f"({eng._mega.m[1].shape[0]} slots, {pend} pending, {w} paused by the walk, "
                f"{b} after a bounce): kernel_ms={t[0]:.5f} (graph replay) plain_ms={t[1]:.4f}")
        del eng, st
        # the gate: ``gate`` cycles of make_partitioned_runner against the
        # single-device run under "rbg"
        devs = sharding.make_device_mesh(S, dev)
        pm = partition.partition_mesh(mesh, S, layout="tet")
        sp = partition.distribute_particles(pm, st0.pos, st0.vel, st0.tet_id, st0.active,
                                            seed=st0.seed, slack=PART_SLACK, step=st0.step)
        pm, sp = partition.shard_arrays(pm, sp, devs)
        run = partition.make_partitioned_runner(pm, bcfg, devs, gate, cap_out_frac=PART_CAP_OUT)
        sp, stats = run(pm, sp, bcfg.dt)
        got = settled_state(torch, cpt, partition, pm, bcfg, devs, sp, n, dev, st0.dtype)
        tet_ok = bool(torch.equal(got.tet_id, ref.tet_id))
        act_ok = bool(torch.equal(got.active, ref.active))
        err = float((got.pos - ref.pos).abs().max())
        log(f"[part] shards={S} {gate} cycles against the single-device run under "
            f"brownian_rng=rbg: tet_identical={int(tet_ok)} active_identical={int(act_ok)} "
            f"pos_max_abs_err={err:.3e} (bound {POS_TOL_PART}) migrated="
            f"{int(stats['migrated'])} settle_rounds={stats['settle_rounds']}")
        need(tet_ok and act_ok and err <= POS_TOL_PART,
             f"partitioned S={S} differs from the single-device rbg run")
        del pm, sp, got
    del ref
    # VertexVelocity: the Pk remote kernel on its path
    pts, _, _ = tmesh.box_points_tets(nside, nside, nside)
    pmesh = cpt.with_pk_rows(cpt.replace_velocity(mesh, vert_vel=vortex(nside)(pts)))
    pcfg = dataclasses.replace(bcfg, velocity_interp="VertexVelocity")
    eng = PartitionedRun(torch, cpt, partition, sharding, pmesh, st0, pcfg, PART_SHARDS, "pk")
    eng.advance(warm, pcfg.dt)
    reset_counts(fused_cuda)
    rounds0 = eng._settle_rounds
    timer = Timer(torch, dev)
    timer.start()
    eng.advance(n_cycles, pcfg.dt)
    ms = timer.stop() / n_cycles
    la = engine_counts(fused_cuda)
    rounds = eng._settle_rounds - rounds0
    launches["rare_pk_remote"] = la.get("rare_resolve_remote", 0)
    t, pend, (w, b) = remote_times(torch, fused, fused_cuda, partition, eng._mega, pcfg.dt,
                                   "rare_pk_remote", "pk", counts, rares, errs)
    times["rare_pk_remote"] = t
    st = eng.snapshot()
    log(f"[part-pk] {gpu_line} | shards={PART_SHARDS} VertexVelocity ms_per_cycle={ms:.4f} "
        f"launches={la} settle_rounds={rounds} migrated={int(eng.migrated)} "
        f"rare_kernel<pk, remote> on "
        f"shard 1 ({pend} pending, {w} paused by the walk, {b} after a bounce): "
        f"kernel_ms={t[0]:.5f} plain_ms={t[1]:.4f}")
    domain_check(torch, cpt, pmesh, st, n_in, "part-pk")
    if dev.type == "cuda":
        need(la.get("rare_resolve_remote") == (2 * n_cycles + rounds) * PART_SHARDS,
             f"partitioned pk: launches {la}, settle rounds {rounds}")
    del eng, pmesh, st
    return launches, times


def phase_drivers_parallel(torch, dev, tmp, rehearse, gpu_line):
    """Phase 12c: the uncoupled driver with the strategies: in process on
    the shipped pitzDaily (1e5 particles, 1000 cycles, float64, no Brownian
    term) single / dp / partitioned with 4 shards, tet and active identical
    and pos within 1e-9; then the CLI with --devices 4 --strategy
    partitioned --no-write (float32)."""
    from cudaparticlesfoam_tpu_torch.io import foamfile
    from cudaparticlesfoam_tpu_torch.models import uncoupled

    particles, delta_t = (200, 0.002) if rehearse else (None, None)
    case = pitz_case(tmp, particles, delta_t)
    path = os.path.join(case, "system", "cudaParticlesDict")
    d = foamfile.read(path)
    d.pop("FoamFile", None)
    d["useBrownianMotion"] = 0
    foamfile.write(path, d, obj_name="cudaParticlesDict")
    runs = {}
    for strat, devices in (("single", None), ("dp", PART_SHARDS),
                           ("partitioned", PART_SHARDS)):
        t0 = time.perf_counter()
        _, st, stats = uncoupled.run(case, write_output=False, dtype="float64", device=dev,
                                     devices=devices, strategy="auto" if devices is None
                                     else strat, log=lambda *a: None)
        runs[strat] = st
        la = {k: v for k, v in stats.get("launches", {}).items() if v}
        log(f"[drivers] {gpu_line} | uncoupled.run {strat} float64 particles={st.n_particles} "
            f"cycles={stats['cycles']} wall_s={stats['wall_s']:.3f} "
            f"advect_s={stats['phases'].get('Advect', 0.0):.3f} launches={la} "
            f"migration={stats.get('migration')} command_s={time.perf_counter() - t0:.1f}")
    ref = runs["single"]
    for strat in ("dp", "partitioned"):
        st = runs[strat]
        tet_ok = bool(torch.equal(st.tet_id, ref.tet_id))
        act_ok = bool(torch.equal(st.active, ref.active))
        err = float((st.pos - ref.pos).abs().max())
        log(f"[drivers] {strat} against single: tet_identical={int(tet_ok)} "
            f"active_identical={int(act_ok)} pos_max_abs_err={err:.3e} (bound {DRIVER_TOL})")
        need(tet_ok and act_ok and err <= DRIVER_TOL, f"the {strat} driver run parts from single")
    cmd = ["uncoupled", case, "--devices", str(PART_SHARDS), "--strategy", "partitioned",
           "--no-write"] + (["--device", "cpu"] if rehearse else [])
    res, secs = cli(cmd)
    need(res.returncode == 0, f"the partitioned CLI run failed: {res.stderr[-3000:]}")
    text = res.stdout
    eng = re.search(r"#adv: engine strategy=(\w+) devices=\[([^\]]*)\]", text)
    runtime = re.search(r"Simulation RunTime=([\d.]+) ms \(([\d.]+)M particle-steps/s\)", text)
    dev_line = re.search(r"#adv: on (.*): Advect ([\d.]+) ms/cycle on the device, ([\d.]+) "
                         r"ms/cycle to issue; kernel launches (\{.*\}); peak device memory "
                         r"([\d.]+) GiB", text)
    n_cycles = int(re.search(r"nCycles: (\d+)", text).group(1))
    ood = [int(x) for x in re.findall(r"Out-of-domain particles\(-tetID\) = (\d+)", text)]
    launches = json.loads(dev_line.group(4).replace("'", '"')) if dev_line else {}
    name, where = (eng.group(1), eng.group(2)) if eng else (None, "")
    log(f"[drivers] {gpu_line} | CLI uncoupled --devices {PART_SHARDS} --strategy partitioned "
        f"--no-write: engine={name} placement=[{where}] "
        f"cycles={n_cycles} runtime_ms={runtime.group(1) if runtime else None} "
        f"advect_ms_per_cycle={dev_line.group(2) if dev_line else 'not measured (CPU)'} "
        f"host_issue_ms_per_cycle={dev_line.group(3) if dev_line else 'not measured (CPU)'} "
        f"launches={launches} out_of_domain={ood} command_s={secs:.1f}")
    need(eng is not None and eng.group(1) == "partitioned", "the CLI ran no partitioned engine")
    if dev.type == "cuda":
        need(eng.group(2) == f"cuda:0 x{PART_SHARDS}" or torch.cuda.device_count() > 1,
             f"placement {eng.group(2)!r}")
        # one stream launch a shard a cycle, and a shard's one more for the
        # final snapshot's settle step (a cycle without displacement)
        need(launches.get("stream_cycle") == (n_cycles + 1) * PART_SHARDS
             and launches.get("rare_resolve_remote", 0) >= 2 * (n_cycles + 1) * PART_SHARDS,
             f"the partitioned CLI run launched {launches}")


# ---------------------------------------------------------------------------
# phase 13: the domain-decomposed flow solve (parallel/{flowshard,graphpart}.py:
# torch ops, no kernel) and the TJunction's Allrun-parallel through the kernels
# ---------------------------------------------------------------------------

FLOW_SHARDS = 4           # the TJunction's decomposeParDict: simple, n (4 1 1)
TJP_PATH = ("coupled driver (TJunction Allrun-parallel, flow on 4 shards, 248,000 cells, "
            "4e6 particles, 3 Eulerian steps)")
TJP_BOUND_S = 240         # phase 13's wall time on the card
SHARD_TOL = 1e-9          # the sharded step, card against CPU, float64, relative
TJP_STEP1_TOL = 5e-4      # sharded against single-device U after step 1 (rel-max, float32)
TJP_RMS_TOL = 5e-3        # per-field rel-RMS after step 3
TJP_DIV_TOL = 1e-4        # the gathered flux's divergence
TJP_STEP_RE = re.compile(STEP_RE.pattern + r" flow_shards=(\d+) halo_rounds=(\d+) "
                         r"halo_refreshes=(\d+) halo_MB=([\d.]+)")
# 13a: (mesh, decomposition, shards, div scheme, steps); tests/test_flowshard.py's
# cases, pitzDaily cut to one of its 2 steps (its Jacobi-CG, ~1,000 iterations a
# solve, took ~13 s a step on the card; phase 13 has 240 s)
SHARD_CASES = [("duct", {}, 4, "upwind", 3), ("duct", {}, 8, "upwind", 3),
               ("duct", {}, 4, "linearUpwind", 3), ("duct", {}, 8, "linearUpwind", 3),
               ("duct6", {"grid": (2, 2, 2)}, 8, "upwind", 3),
               ("pitz", {"grid": "graph"}, 8, "upwind", 1)]


def sharded_duct_run(torch, fs, pm, dev, kw, S, scheme, n_steps, pitz):
    """The port's single-device PIMPLE on ``dev`` and the sharded one on
    ``dev`` and (but for pitzDaily, whose Jacobi-CG takes ~1,000 iterations
    a solve) on the CPU from the same float64 inputs (tests/test_flowshard.py's
    duct or pitzDaily set-up): (single u, p; [(u, p, CG counts, continuity,
    placement) on dev, and on the CPU])."""
    from cudaparticlesfoam_tpu_torch.models import fv, pimple
    from cudaparticlesfoam_tpu_torch.models.simple import FlowState

    speed, dt = (10.0, 5e-5) if pitz else (1.0, 0.02)
    cfg = pimple.PimpleConfig(nu=1e-5 if pitz else 1e-3, n_outer=1, n_correctors=2, n_jacobi=8,
                              p_tol=1e-11 if pitz else 1e-12, p_max_iter=2000 if pitz else 600,
                              div_scheme=scheme)
    out, single = [], None
    for d in (dev,) if pitz else (dev, torch.device("cpu")):
        m = fv.fv_mesh(pm, dtype=torch.float64, device=d)
        wall = ("noSlip", 0.0)
        u_bcs = fv.make_bcs(m, {"inlet": ("fixedValue", [speed, 0.0, 0.0]), "walls": wall,
                                "upperWall": wall, "lowerWall": wall,
                                "frontAndBack": ("empty", 0.0)}, 3)
        p_bcs = fv.make_bcs(m, {"outlet": ("fixedValue", 0.0)}, 1)
        u0 = np.tile([speed, 0.0, 0.0], (m.n_cells, 1))
        if single is None:
            ut = torch.as_tensor(u0, device=d)
            st = FlowState(u=ut, p=torch.zeros(m.n_cells, dtype=torch.float64, device=d),
                           flux=fv.flux_of(m, ut, u_bcs))
            for _ in range(n_steps):
                st, _ = pimple.pimple_step(m, st, u_bcs, p_bcs, cfg, dt)
            single = (fv.host(st.u), fv.host(st.p))
        smesh, bglob = fs.decompose(pm, S, dtype=torch.float64, device=d, **kw)
        ub, pb = fs.shard_bcs(u_bcs, bglob, smesh), fs.shard_bcs(p_bcs, bglob, smesh)
        u, p = fs.scatter_cells(smesh, u0), fs.scatter_cells(smesh, np.zeros(m.n_cells))
        flux = fs.flux_init(smesh, u, ub)
        step = fs.make_sharded_pimple(smesh, cfg)
        its = []
        for _ in range(n_steps):
            u, p, flux, diag = step(smesh, u, p, flux, ub, pb, dt)
            its += diag["p_iters"]
        out.append((fv.host(fs.gather_cells(smesh, u)), fv.host(fs.gather_cells(smesh, p)),
                    its, float(diag["continuity"]), fs.placement(smesh.devices)))
    return single, out


def rel_max(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def phase_flowshard_parity(torch, dev, tmp, rehearse, gpu_line):
    """Phase 13a, float64: the sharded PIMPLE step (tests/test_flowshard.py's
    cases: the duct in 4 and 8 slabs, upwind and linearUpwind, the (2,2,2)
    grid, the graph map on pitzDaily) on the card against the port's
    single-device step on the card (JAX's tolerances) and against the same
    sharded step on the CPU (within 1e-9, Jacobi-CG counts within 1%; not
    pitzDaily's, on the card only); then
    ShardedFlowSolver on the shrunk TJunction (kEpsilon, local AMG-CG, 4
    shards, p_tol 1e-11), one step on the card against the CPU: every
    field within 1e-9, the AMG-CG counts equal; and a second solver's step
    on the card identical bit for bit to the first (``fv.index_sum``'s
    fixed order)."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh
    from cudaparticlesfoam_tpu_torch.models import case as caselib
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.parallel import flowshard as fs

    common = flow_common(torch)
    paths = {"duct": common.flowshard_duct(tmp), "duct6": common.flowshard_duct(tmp, 12, 6, 6),
             "pitz": common.PITZ_BMD}
    for mesh, kw, S, scheme, n_steps in SHARD_CASES:
        if rehearse and mesh == "pitz":
            continue        # the duct cases cover the rehearsal
        pm = blockmesh.generate(paths[mesh])
        t0 = time.perf_counter()
        (su, sp), out = sharded_duct_run(torch, fs, pm, dev, kw, S, scheme, n_steps,
                                         mesh == "pitz")
        u, p, its, cont, where = out[0]
        cu, cp, cits, _, _ = out[-1]
        if mesh == "pitz":
            ok_single = (np.abs(u - su).max() / 10.0 < 1e-6
                         and np.abs(p - sp).max() / (np.abs(sp).max() + 1e-12) < 1e-5)
        else:
            ok_single = (np.abs(u - su).max() < 1e-8 * max(np.abs(su).max(), 1.0)
                         and np.abs(p - sp).max() < 1e-6 * max(np.abs(sp).max(), 1.0)
                         and cont < 1e-8)
        err = max(rel_max(u, cu), rel_max(p, cp))
        cg_ok = len(its) == len(cits) and all(abs(a - b) <= max(1, 0.01 * b)
                                              for a, b in zip(its, cits))
        versus = (f"card_vs_cpu max_rel_err={err:.3e} (bound {SHARD_TOL}) cg_iterations={its} "
                  f"cpu={cits}" if len(out) > 1 else f"cg_iterations={its} (the card only)")
        log(f"[flowshard-parity] {gpu_line} | {mesh} {kw or 'slabs'} shards={S} [{where}] "
            f"{scheme} steps={n_steps} cells={pm.n_cells} float64: vs_single_device "
            f"u_max_abs={np.abs(u - su).max():.3e} p_max_abs={np.abs(p - sp).max():.3e} "
            f"continuity={cont:.3e} single_ok={int(ok_single)} | {versus} "
            f"s={time.perf_counter() - t0:.1f}")
        need(ok_single and err <= SHARD_TOL and cg_ok,
             f"13a {mesh} {kw} {S} shards {scheme}: the sharded step disagrees")
    # the solver on the shrunk TJunction: local AMG-CG, the closure, the p0 ramps
    case_dir = common.shrink_tjunction(os.path.join(tmp, "tj"), num_particles=10)
    common.write_polymesh_of(case_dir)
    res = []
    for d in (dev, dev, torch.device("cpu")):
        case = caselib.load_case(case_dir, log=lambda *a: None, device=d)
        flow = fs.ShardedFlowSolver(case, FLOW_SHARDS, log=lambda *a: None, device=d,
                                    dtype=torch.float64, p_tol=1e-11)
        r = flow.advance(1e-3)
        st, kes = flow.state, flow.kes
        res.append(({k: fv.host(getattr(st, k)) for k in ("u", "p", "flux")}
                    | {k: fv.host(getattr(kes, k)) for k in ("k", "eps", "nut")},
                    r["p_iters"], fs.placement(flow.devices)))
    (a, ia, where), (a2, _, _), (b, ib, _) = res
    same = all(np.array_equal(a[k], a2[k]) for k in a)
    errs = {k: rel_max(a[k], b[k]) for k in a}
    log(f"[flowshard-parity] {gpu_line} | ShardedFlowSolver, shrunk TJunction (1,984 cells, "
        f"kEpsilon, local AMG-CG, p_tol 1e-11) shards={FLOW_SHARDS} [{where}] one step, "
        f"card vs cpu float64: max_rel_err={max(errs.values()):.3e} (bound {SHARD_TOL}; "
        f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())}) amg_cg_iterations={ia} "
        f"cpu={ib} cg_equal={int(ia == ib)} run_to_run_identical={int(same)}")
    need(max(errs.values()) <= SHARD_TOL and ia == ib,
         "13a: ShardedFlowSolver card != CPU on the shrunk TJunction")
    need(same, "13a: two ShardedFlowSolver steps from the same inputs differ on the card")


def phase_tj_parallel_cli(torch, dev, case, tmp, rehearse, gpu_line):
    """Phase 13b, the Allrun-parallel through the CLI: ``coupled <case>
    --flow-devices 4 --no-write`` on 11c's case (248,000 cells, 4e6
    particles, kEpsilon, float32, 11c's cuts: 3 steps, the particle window
    opened at 0; and no frames, which 11c writes at this width).  Prints
    each step's line (flow ms, CG iterations per corrector, halo refreshes
    and MB, refresh and Advect ms) and the run's init, launches and peak
    memory; checks one stream and one rare launch a cycle and every lane in
    the domain.  Returns (launches, seconds)."""
    cmd = ["coupled", case, "--steps", str(TJ_STEPS), "--flow-devices", str(FLOW_SHARDS),
           "--no-write"]
    res, secs = cli(cmd + (["--device", "cpu"] if rehearse else []), timeout=1000)
    need(res.returncode == 0, f"the sharded TJunction run failed: {res.stderr[-3000:]}")
    text = res.stdout
    steps = [m.groups() for m in TJP_STEP_RE.finditer(text)]
    need(len(steps) == TJ_STEPS, f"the sharded run printed {len(steps)} step lines")
    init = re.search(r"#coupled: init: (.*)", text).group(1)
    placed = re.search(r"#flow: sharded PIMPLE on (\d+) devices \[([^\]]*)\], (\d+) cells "
                       r"\((\d+)/shard, (\d+) halo rounds\)", text)
    grid = re.search(r"#flow: decomposition grid (\([^)]*\))", text)
    dev_line = re.search(r"#coupled: on (.*): kernel launches (\{.*\}); peak device memory "
                         r"([\d.]+) GiB", text)
    domain = re.search(r"#coupled: (\d+) of (\d+) lanes active, every active lane in the "
                       r"domain: (\d)", text)
    cycles = sum(int(s[3]) for s in steps)
    for s in steps:
        log(f"[tj-par] {gpu_line} | CLI step {s[0]} t={s[1]} dt_e={s[2]} cycles={s[3]} "
            f"flow_ms={s[4]} (device) flow_host_ms={s[5]} cg_iterations_per_corrector={s[6]} "
            f"continuity={s[7]} velocity_refresh_ms={s[9]} advect_ms_per_cycle={s[10]} "
            f"(device) advect_issue_ms_per_cycle={s[11]} flow_shards={s[13]} "
            f"halo_rounds={s[14]} halo_refreshes={s[15]} halo_MB={s[16]}")
    launches = json.loads(dev_line.group(2).replace("'", '"')) if dev_line else {}
    log(f"[tj-par] {gpu_line} | TJunction Allrun-parallel via the CLI (coupled --flow-devices "
        f"{FLOW_SHARDS} --no-write, 11c's cuts): decomposition {grid.group(1) if grid else None} "
        f"shards={placed.group(1)} [{placed.group(2)}] cells={placed.group(3)} "
        f"per_shard={placed.group(4)} halo_rounds={placed.group(5)} init: {init} "
        f"cycles={cycles} launches={launches} "
        f"peak_device_GiB={dev_line.group(3) if dev_line else 'n/a (cpu)'} "
        f"active={domain.group(1)} of {domain.group(2)} all_active_in_domain={domain.group(3)} "
        f"command_s={secs:.1f}")
    need(placed is not None and int(placed.group(1)) == FLOW_SHARDS, "no sharded flow solver")
    need(domain.group(3) == "1" and domain.group(1) == domain.group(2),
         "the sharded TJunction run lost lanes or left the domain")
    need(all(int(s[13]) == FLOW_SHARDS and int(s[15]) > 0 for s in steps),
         "a step ran without the flow's shards or halo exchange")
    if dev.type == "cuda":
        need(placed.group(2) == f"cuda:0 x{FLOW_SHARDS}" or torch.cuda.device_count() > 1,
             f"placement {placed.group(2)!r}")
        particle = {k: v for k, v in launches.items() if k not in AMG_LAUNCH_KEYS}
        need(particle == {"stream_cycle": cycles, "rare_resolve": cycles},
             f"the sharded TJunction run launched {particle}, not one stream and one rare "
             f"kernel a cycle ({cycles} cycles)")
        need(all(launches.get(k, 0) > 0 for k in AMG_KERNELS),
             f"the sharded flow ran without the pressure-solve kernels: {launches}")
    return launches, secs


def timed(torch, dev, fn):
    """(result, device ms, host ms) of one call: CUDA events on the card,
    the host clock on both."""
    timer = Timer(torch, dev)
    timer.start()
    h0 = time.perf_counter()
    r = fn()
    host = (time.perf_counter() - h0) * 1e3
    return r, timer.stop(), host


def phase_tj_parallel_fields(torch, fused, fused_cuda, dev, run, errs, counts, rares, gpu_line):
    """Phase 13b in process, and 13c: the TJunction at full width (11c's
    case as phase 11 loaded it, float32) with the single-device flow and the
    4-shard flow side by
    side from the same start and the same dt each step (the single solver's
    stable_dt): after step 1 U within 5e-4 (rel-max), after step 3 U, p, k,
    epsilon and nut within 5e-3 (rel-RMS) and the gathered flux's divergence
    below 1e-4; per step both flows' device and host ms and CG iterations,
    the halo refreshes and MB; ShardedFlowSolver's decompose and
    build_local_amg seconds; one more sharded step under torch.profiler
    (CUDA activity only: its kernels, busy ms, span on CUDA events and so
    its idle share).  13c: the particles seeded
    and advanced over step 1's interval on the sharded field, then one cycle
    of stream_kernel and rare_kernel against their plain versions.  Returns
    the kernels' times."""
    from cudaparticlesfoam_tpu_torch.models import case as caselib
    from cudaparticlesfoam_tpu_torch.models import fv, pimple
    from cudaparticlesfoam_tpu_torch.parallel import flowshard as fs

    quiet = lambda *a: None  # noqa: E731
    tcase, cfg = run.case, run.cfg
    h0 = time.perf_counter()
    single = pimple.FlowSolver.from_case(tcase, log=quiet, device=dev)
    single_s = time.perf_counter() - h0
    h0 = time.perf_counter()
    sharded = fs.ShardedFlowSolver(tcase, FLOW_SHARDS, log=quiet, device=dev)
    sharded_s = time.perf_counter() - h0
    hs = sharded.smesh.halo_stats()
    log(f"[tj-par] {gpu_line} | in process: {sharded.m.n_cells} cells, shards={FLOW_SHARDS} "
        f"[{fs.placement(sharded.devices)}] n_loc={sharded.smesh.n_loc} "
        f"halo_rounds={hs['rounds']} pairs={hs['pairs']} halo_slots={sharded.smesh.n_halo} "
        f"local_amg_levels={sharded.lamg.n_levels} decompose_s={sharded.decompose_s:.2f} "
        f"build_local_amg_s={sharded.amg_s:.2f} sharded_init_s={sharded_s:.2f} "
        f"single_init_s={single_s:.2f}")
    times, st = {}, None
    for k in range(1, TJ_STEPS + 1):
        dt_e = single.stable_dt(tcase.control)
        r1, ms1, host1 = timed(torch, dev, lambda: single.advance(dt_e))
        calls0, bytes0 = fs.halo_refresh.calls, fs.halo_refresh.bytes
        r2, ms2, host2 = timed(torch, dev, lambda: sharded.advance(dt_e))
        ua, ub = fv.host(single.state.u), fv.host(sharded.state.u)
        line = (f"[tj-par] {gpu_line} | step {k} dt_e={dt_e:g} flow_ms single={ms1:.1f} "
                f"sharded={ms2:.1f} (device) flow_host_ms single={host1:.1f} "
                f"sharded={host2:.1f} cg_iterations_per_corrector single={r1['p_iters']} "
                f"sharded={r2['p_iters']} halo_refreshes={fs.halo_refresh.calls - calls0} "
                f"halo_MB={(fs.halo_refresh.bytes - bytes0) / 1e6:.3f} "
                f"continuity single={single.last['continuity']:.3e} "
                f"sharded={sharded.last['continuity']:.3e} "
                f"u_rel_max={np.abs(ua - ub).max() / (np.abs(ua).max() + 1e-12):.3e}")
        log(line)
        if k == 1:
            need(np.abs(ua - ub).max() / (np.abs(ua).max() + 1e-12) <= TJP_STEP1_TOL,
                 "13b: the sharded U parts from the single-device U after step 1")
            # 13c: the particles over step 1's interval on the sharded field
            run.state, run.step0 = caselib.init_particles(tcase, log=quiet), 0
            _, ref_ms, _ = timed(torch, dev,
                                 lambda: tcase.update_velocity(sharded.cell_velocity()))
            run.advance_interval(dt_e)
            st = run.state
            log(f"[tj-par] {gpu_line} | velocity refresh from the gathered sharded U: "
                f"{ref_ms:.1f} ms; step 1's interval advanced {st.n_particles} lanes")
            times = phase_tjunction_cycle(torch, fused, fused_cuda, dev, tcase, st, cfg, errs,
                                          counts, rares, gpu_line, tag="tjunction_par",
                                          label="tj-par-cycle")
            del st
    rms = {}
    for name, xa, xb in (("U", single.state.u, sharded.state.u),
                         ("p", single.state.p, sharded.state.p),
                         ("k", single.kes.k, sharded.kes.k),
                         ("epsilon", single.kes.eps, sharded.kes.eps),
                         ("nut", single.kes.nut, sharded.kes.nut)):
        a, b = fv.host(xa).astype(np.float64), fv.host(xb).astype(np.float64)
        rms[name] = float(np.sqrt(((a - b) ** 2).mean()) / (np.sqrt((a ** 2).mean()) + 1e-12))
    div = float(fv.surface_sum(single.m, sharded.state.flux).abs().max())
    dt_e = single.stable_dt(tcase.control)
    h0 = time.perf_counter()
    (kernels, busy, ms4, its4) = profile_kernels(torch, dev, lambda: sharded.advance(dt_e))
    prof_s = time.perf_counter() - h0
    idle = "not measured" if busy is None else f"{1.0 - busy / ms4:.3f}"
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None)
    log(f"[tj-par] {gpu_line} | after step {TJ_STEPS}: rel_rms "
        f"{' '.join(f'{k}={v:.3e}' for k, v in rms.items())} (bound {TJP_RMS_TOL}) "
        f"gathered_flux_divergence_max={div:.3e} (bound {TJP_DIV_TOL}) | step {TJ_STEPS + 1} "
        f"profiled (CUDA activity): kernels={unmeasured(kernels)} "
        f"kernel_busy_ms={unmeasured(busy, '%.1f')} span_ms={unmeasured(ms4, '%.1f')} "
        f"idle_share={idle} (both of the profiled step) cg_iterations={its4} "
        f"(profile_s={prof_s:.1f}) | peak_device_GiB={unmeasured(peak, '%.3f')}")
    need(max(rms.values()) <= TJP_RMS_TOL and div <= TJP_DIV_TOL,
         "13b: the sharded fields part from the single-device run after step 3")
    phase_amg_sharded(torch, dev, sharded, dt_e, (kernels, busy, ms4, its4), errs, gpu_line)
    return times


def profile_kernels(torch, dev, step):
    """(kernels, their busy ms, the call's span on CUDA events, the step's
    CG iterations) of one call of ``step`` (a flow solver's advance) under
    torch.profiler with only the CUDA activity.  A sharded step launches
    ~5e5 kernels: the profiler's event tree (``prof.events()``) takes ~80 s
    to build for them, so the kernels are read from its raw records where
    this torch has them.  On the CPU (None, None, None, counts)."""
    if dev.type != "cuda":
        return None, None, None, step()["p_iters"]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    skip = ("Memcpy", "Memset")
    timer = Timer(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timer.start()
        res = step()
        span = timer.stop()
    raw = getattr(getattr(prof.profiler, "kineto_results", None), "events", None)
    raw = raw() if raw is not None else []
    if raw and all(hasattr(raw[0], k) for k in ("duration_ns", "device_type", "name")):
        ns = [e.duration_ns() for e in raw
              if e.device_type() == DeviceType.CUDA and not e.name().startswith(skip)]
        return len(ns), sum(ns) / 1e6, span, res["p_iters"]
    kern = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith(skip)]
    return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3, span, res["p_iters"]


def phase_dryrun(torch, dev, gpu_line):
    """Phase 13d: the port's dryrun_multichip(4): DP and partitioned
    particles against the single-device run, the sharded PIMPLE step."""
    from cudaparticlesfoam_tpu_torch import dryrun

    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(FLOW_SHARDS, device=dev, log=lambda *a: None)
    log(f"[dryrun] {gpu_line} | dryrun_multichip({FLOW_SHARDS}) on [{', '.join(res['devices'])}]: "
        f"dp_max_abs_err={res['dp_max_abs_err']:.3e} active={res['active']} of "
        f"{res['particles']} partitioned_max_abs_err={res['partitioned_max_abs_err']:.3e} "
        f"migrated={res['migrated']} deferred={res['deferred']} sharded PIMPLE "
        f"cells={res['n_cells']} continuity={res['continuity']:.3e} "
        f"cg_iterations={res['p_iters']} s={time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------------
# phase 14: the AMG-CG pressure solve's kernels (csrc/amg.cu) and the CG
# iteration replayed from a CUDA graph
# ---------------------------------------------------------------------------

AMG_KERNELS = ("fv_matvec", "amg_down", "amg_up", "amg_tail")
AMG_LAUNCH_KEYS = AMG_KERNELS + ("cg_graph_replays",)    # fv.solver_launches()
AMG_KERNEL_NAMES = tuple(f"{k}_kernel" for k in AMG_KERNELS)
PACK_KERNEL_NAMES = ("pack_kernel", "unpack_kernel")   # csrc/pack.cu
# the XLA code each kernel takes over (the JAX package fuses it in the CG's
# lax.while_loop; no Pallas body)
AMG_REPLACES = {"fv_matvec": "cudaparticlesfoam_tpu/models/fv.py:420",
                "amg_down": "cudaparticlesfoam_tpu/models/fv.py:562",
                "amg_up": "cudaparticlesfoam_tpu/models/fv.py:565",
                "amg_tail": "cudaparticlesfoam_tpu/models/fv.py:549"}
AMG_BOXES = {65_536: (64, 32, 32), 65_499: (3119, 7, 3)}     # a ragged last block
AMG_BOXES_REHEARSAL = {256: (8, 8, 4), 231: (11, 7, 3)}
AMG_SEED = 14
AMG_PITZ_PATH = "steady-flow driver (pitzDaily Allrun, simple, 100 SIMPLE iterations)"


def amg_box(dst, cells):
    """A box of nx x ny x nz unit hex cells through the port's blockMesh."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh

    nx, ny, nz = cells
    path = os.path.join(dst, f"box_{nx}_{ny}_{nz}", "blockMeshDict")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(
            "FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }\n"
            "convertToMeters 1;\n"
            f"vertices ( (0 0 0) ({nx} 0 0) ({nx} {ny} 0) (0 {ny} 0) (0 0 {nz}) ({nx} 0 {nz}) "
            f"({nx} {ny} {nz}) (0 {ny} {nz}) );\n"
            f"blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading (1 1 1) );\n"
            "boundary ( walls { type wall; faces ((0 4 7 3) (1 2 6 5) (0 1 5 4) (3 7 6 2) "
            "(0 3 2 1) (4 5 6 7)); } );\n")
    return blockmesh.generate(path)


def amg_system(torch, fv, m, dtype, seed):
    """A pressure-like matrix on ``m`` in ``dtype`` from ``seed``: off < 0 on
    the faces, diag their negated sum plus a positive part, level 0's lower
    apart from its upper; and a right-hand side."""
    rng = np.random.default_rng(seed)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=m.device)  # noqa: E731
    off = as_t(-rng.uniform(0.5, 2.0, m.n_internal))
    diag = fv.index_sum(m.n_cells, [(m.own_i, -off), (m.neighbour, -off)],
                        out=as_t(rng.uniform(0.1, 1.0, m.n_cells)))
    lower = off * as_t(rng.uniform(0.9, 1.1, m.n_internal))
    A = fv.FvMatrix(diag=diag, lower=lower, upper=off,
                    source=torch.zeros(m.n_cells, 1, dtype=dtype, device=m.device))
    return A, as_t(rng.standard_normal(m.n_cells))


def amg_as(fv, A, dtype):
    return fv.FvMatrix(diag=A.diag.to(dtype), lower=A.lower.to(dtype),
                       upper=A.upper.to(dtype), source=A.source.to(dtype))


def ulp_gap(torch, got, want):
    """(rows differing, the largest gap in units of the last place of want)."""
    d = (got - want).abs()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    rows = d.reshape(d.shape[0], -1).amax(dim=1) > 0
    return int(rows.sum()), float((d / ulp).max()) if d.numel() else 0.0


def seg_matvec(fv, m, A, phi):
    """PR 13's card matvec: fv.index_sum (a gather in plan order and
    torch.segment_reduce a row) onto diag*x."""
    if phi.ndim == 2:
        out, up, lo = A.diag[:, None] * phi, A.upper[:, None], A.lower[:, None]
    else:
        out, up, lo = A.diag * phi, A.upper, A.lower
    return fv.index_sum(m.n_cells, [(m.own_i, up * phi[m.neighbour]),
                                    (m.neighbour, lo * phi[m.own_i])], out=out)


def seg_vcycle(fv, m, h, A, levels, r):
    """PR 13's card V-cycle, op by op over fv.index_sum."""
    omega = 0.65

    def descend(li, r):
        if li == 0:
            diag, off, own, nei = A.diag, A.upper, m.own_i, m.neighbour
        else:
            diag, off = levels[li - 1]
            own, nei = h.owners[li - 1], h.neighs[li - 1]
        x = omega * r / diag
        if li == len(h.sizes):
            for _ in range(12):
                x = x + omega * (r - fv._sym_matvec(diag, off, own, nei, x)) / diag
            return x
        r1 = r - fv._sym_matvec(diag, off, own, nei, x)
        xc = descend(li + 1, fv.index_sum(h.sizes[li], [(h.aggs[li], r1)]))
        x = x + xc[h.aggs[li]]
        return x + omega * (r - fv._sym_matvec(diag, off, own, nei, x)) / diag

    return descend(0, r)


def seg_local_vcycle(fv, lamg, s, m, diag0, off0, levels, r0, omega=0.65):
    """PR 13's card local V-cycle of a shard, op by op over fv.index_sum."""
    t, L = lamg.shard[s], lamg.n_levels

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
        return x + omega * (r - matvec_l(li, x)) / d_

    return descend(0, r0)


class AmgMode:
    """The pressure solve as the port runs it ("graph": the kernels, the
    tail and the CG graph), with the level-by-level split ("graph 2L+1": TAIL_ROWS =
    0, the coarsest alone in the tail), with the CG loop eager ("eager":
    the kernels alone; "eager 2L+1"), or op by op on the card
    ("op-by-op": the matvec and the V-cycles over fv.index_sum, the loop
    eager), for measuring beside each other; the port itself has no such
    switch but fv._CG_GRAPH and amg_cuda.TAIL_ROWS."""

    def __init__(self, fv, fs, mode):
        self.fv, self.fs, self.mode = fv, fs, mode
        self.rows = TailRows(0 if mode.endswith("2L+1") else None)

    def __enter__(self):
        fv, fs = self.fv, self.fs
        self.saved = (fv.matvec, fv.amg_vcycle, fs._local_vcycle, fv._CG_GRAPH)
        fv._CG_GRAPH = self.mode.startswith("graph")
        if self.mode == "op-by-op":
            fv.matvec = lambda m, A, phi: seg_matvec(fv, m, A, phi)
            fv.amg_vcycle = lambda *a: seg_vcycle(fv, *a)
            fs._local_vcycle = lambda *a, **k: seg_local_vcycle(fv, *a, **k)
        self.rows.__enter__()
        return self

    def __exit__(self, *exc):
        fv, fs = self.fv, self.fs
        self.rows.__exit__(*exc)
        fv.matvec, fv.amg_vcycle, fs._local_vcycle, fv._CG_GRAPH = self.saved
        return False


# 14c's turns: the tail and the level-by-level split in turns, then the eager loop and
# the op-by-op path
AMG_TURNS = ("graph", "graph 2L+1", "graph 2L+1", "graph", "eager", "op-by-op")


def amg_level_cases(torch, fv, amg, m, h, A, dtype, seed):
    """Per level 0..L of h: (n, rows, diag, upper, lower, aggs plan or None,
    agg, r, x3, xc) with the level's Galerkin operator of A in dtype and
    random inputs from seed."""
    A = amg_as(fv, A, dtype)
    rng = np.random.default_rng(seed)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=m.device)  # noqa: E731
    ops = [(m.n_cells, m.own_i, m.neighbour, A.diag, A.upper, A.lower)]
    for li, (d_, o_) in enumerate(fv.amg_coarse_ops(m, h, A)):
        ops.append((h.sizes[li], h.owners[li], h.neighs[li], d_, o_, o_))
    out = []
    for li, (n, own, nei, d_, up, lo) in enumerate(ops):
        coarse = li < len(h.sizes)
        out.append(dict(
            n=n, rows=amg.row_plan(n, own, nei), own=own, nei=nei, diag=d_, up=up, lo=lo,
            aggs=amg.agg_plan(h.sizes[li], h.aggs[li]) if coarse else None,
            agg=h.aggs[li] if coarse else None, r=as_t(rng.standard_normal(n)),
            x3=as_t(rng.standard_normal((n, 3))),
            xc=as_t(rng.standard_normal(h.sizes[li])) if coarse else None))
    return out


class TailRows:
    """amg_cuda.TAIL_ROWS set for a with-block (None: left as it is), and as
    it was after it: the split is a module constant, not a user setting."""

    def __init__(self, tail_rows=None):
        from cudaparticlesfoam_tpu_torch.ops import amg_cuda

        self.amg_cuda, self.want = amg_cuda, tail_rows

    def __enter__(self):
        self.saved = self.amg_cuda.TAIL_ROWS
        if self.want is not None:
            self.amg_cuda.TAIL_ROWS = self.want
        return self

    def __exit__(self, *exc):
        self.amg_cuda.TAIL_ROWS = self.saved
        return False


def tail_lists(lvs):
    """(rows, aggs, ops, prolong) of amg_level_cases' levels, the kernels'
    view of the hierarchy (no valid)."""
    return ([lv["rows"] for lv in lvs], [lv["aggs"] for lv in lvs[:-1]],
            [(lv["diag"], lv["up"]) for lv in lvs], [(lv["agg"], None) for lv in lvs[:-1]])


def tail_fits(amg_cuda, rows, aggs, prolong, elem):
    """(the shared-memory layout of a tail of these levels (its plan at
    amg_cuda.TAIL_BLOCK0_ROWS; amg_cuda.tail_layout), None), or (None, the
    layout's message) where it raises: the vectors do not fit in a block's
    shared memory, or a tail from at most TAIL_ROWS rows cannot stage
    every level."""
    from cudaparticlesfoam_tpu_torch.ops import amg_tail

    plan = amg_tail.tail_plan(rows, aggs, prolong, amg_cuda.TAIL_BLOCK0_ROWS)
    try:
        return amg_cuda.tail_layout(plan, elem, any(v is not None for _, v in prolong)), None
    except ValueError as exc:
        return None, str(exc)


def tail_splits(torch, amg, amg_cuda, rows, aggs, ops, prolong, r):
    """The tail against tail_plain at every split t = L .. 0 (the residual
    at t from the plain downs above it) whose layout fits (tail_fits); on
    the card a split that does not fit must raise: (all bit for bit, the
    largest |difference|, checks, splits that do not fit, splits with a
    level whose segment is read from global memory, not staged, the first
    raise's message or None)."""
    rs = [r]
    for li, ag in enumerate(aggs):
        rs.append(amg.down_plain(rows[li], ag, *ops[li], rs[li]))
    same, err, checks, too_big, unstaged, why = True, 0.0, 0, 0, 0, None
    for t in range(len(aggs), -1, -1):
        args = (rows[t:], aggs[t:], ops[t:], prolong[t:], rs[t])
        lay, msg = tail_fits(amg_cuda, rows[t:], aggs[t:], prolong[t:], r.element_size())
        if lay is None:
            too_big += 1
            if r.device.type == "cuda":
                try:
                    amg_cuda.amg_tail(*args)
                    same = False
                except ValueError as exc:
                    msg = str(exc)
            why = why or f"t={t}: {msg}"
            continue
        unstaged += not all(lay.stage)
        want = amg.tail_plain(*args)
        got = amg_cuda.amg_tail(*args)
        same &= bitwise_equal(torch, got, want)
        err = max(err, float((got - want).abs().max()))
        checks += 1
    return same, err, checks, too_big, unstaged, why


def phase_amg_first(torch, dev, tmp, errs, gpu_line):
    """14a on a 16 x 16 x 8 box (amg_system's matrix) with block 0 from 32
    rows, so that up to six levels spread over the cluster: the tail at
    every split against tail_plain, float32 and float64, bit for bit, one
    launch at a time and synchronised, each split logged before its
    launch (a fault names its split)."""
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda, amg_tail

    m = fv.fv_mesh(amg_box(tmp, (16, 16, 8)), dtype=torch.float32, device=dev)
    h = fv.build_amg(m, min_coarse=20)
    A, _ = amg_system(torch, fv, m, torch.float32, AMG_SEED)
    most = 0
    for dtype in (torch.float32, torch.float64):
        lvs = amg_level_cases(torch, fv, amg, m, h, A, dtype, AMG_SEED)
        rows, aggs, ops, prolong = tail_lists(lvs)
        rs = [lvs[0]["r"]]
        for k, ag in enumerate(aggs):
            rs.append(amg.down_plain(rows[k], ag, *ops[k], rs[k]))
        for t in range(len(aggs), -1, -1):
            args = (rows[t:], aggs[t:], ops[t:], prolong[t:], rs[t])
            C = amg_tail.tail_plan(rows[t:], aggs[t:], prolong[t:], 32).cluster
            most = max(most, C)
            log(f"[amg-first] {str(dtype).split('.')[1]} split t={t} (rows {rows[t].n}, "
                f"cluster levels {C}) ...")
            got = amg_cuda.amg_tail(*args, block0_rows=32)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            want = amg.tail_plain(*args)
            errs["amg_tail"] = max(errs.get("amg_tail", 0.0), float((got - want).abs().max()))
            need(bitwise_equal(torch, got, want),
                 f"14a: the tail differs from its plain version on the 16x16x8 box at split {t} "
                 f"({dtype}, block 0 from 32 rows)")
    log(f"[amg-parity] {gpu_line} | box 16x16x8 ({m.n_cells} cells), block 0 from 32 rows "
        f"(up to {most} cluster levels): amg_tail at every split = tail_plain bit for bit in "
        f"float32 and float64")


def phase_amg_parity(torch, dev, tag, m, h, A, errs, gpu_line):
    """14a: each kernel against its plain version at every level of h (A's
    Galerkin operators), float32 and float64, bit for bit: fv_matvec on
    level 0 (lower and upper apart) and on each coarse level (symmetric)
    with x [nc] and [nc, 3], amg_down and amg_up on each level above the
    coarsest, amg_tail at every split (tail_splits); and the
    kernels' matvec against the op-by-op card path (fv.index_sum:
    torch.segment_reduce a row) on the same inputs, as rows differing and
    the largest gap in ulps."""
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        same, checks, gap = True, 0, {1: [0, 0.0], 3: [0, 0.0]}
        lvs = amg_level_cases(torch, fv, amg, m, h, A, dtype, AMG_SEED)
        for lv in lvs:
            rows, d_, up, lo = lv["rows"], lv["diag"], lv["up"], lv["lo"]
            pairs = [("fv_matvec", lambda x=x: amg_cuda.fv_matvec(rows, d_, up, lo, x),
                      lambda x=x: amg.matvec_plain(rows, d_, up, lo, x))
                     for x in (lv["r"], lv["x3"])]
            if lv["aggs"] is not None:
                pairs += [
                    ("amg_down", lambda: amg_cuda.amg_down(rows, lv["aggs"], d_, up, lv["r"]),
                     lambda: amg.down_plain(rows, lv["aggs"], d_, up, lv["r"])),
                    ("amg_up", lambda: amg_cuda.amg_up(rows, d_, up, lv["r"], lv["agg"], lv["xc"]),
                     lambda: amg.up_plain(rows, d_, up, lv["r"], lv["agg"], lv["xc"]))]
            for key, kern, plain in pairs:
                got, want = kern(), plain()
                ok = bitwise_equal(torch, got, want)
                same &= ok
                checks += 1
                errs[key] = max(errs.get(key, 0.0), float((got - want).abs().max()))
            for x in (lv["r"], lv["x3"]):
                k = 1 if x.ndim == 1 else 3
                seg = fv.index_sum(lv["n"], [
                    (lv["own"], (up if k == 1 else up[:, None]) * x[lv["nei"]]),
                    (lv["nei"], (lo if k == 1 else lo[:, None]) * x[lv["own"]])],
                    out=(d_ if k == 1 else d_[:, None]) * x)
                nrow, g = ulp_gap(torch, amg_cuda.fv_matvec(rows, d_, up, lo, x), seg)
                gap[k][0] += nrow
                gap[k][1] = max(gap[k][1], g)
        tail_same, tail_err, tail_checks, too_big, unstaged, why = tail_splits(
            torch, amg, amg_cuda, *tail_lists(lvs), lvs[0]["r"])
        errs["amg_tail"] = max(errs.get("amg_tail", 0.0), tail_err)
        log(f"[amg-parity] {gpu_line} | {tag}, {name}: levels={len(h.sizes) + 1} "
            f"sizes={[m.n_cells] + list(h.sizes)} checks={checks} kernel_eq_plain={int(same)} "
            f"| amg_tail at every split t={len(h.sizes)}..0: checks={tail_checks} "
            f"kernel_eq_plain={int(tail_same)} splits_too_big_for_shared_memory={too_big} "
            f"(raise on the card) splits_with_a_level_read_from_global_memory={unstaged} "
            + (f"(first raise: {why}) " if why else "")
            + f"| the kernels' matvec against the op-by-op segment_reduce path: x[nc] "
            f"rows_differing={gap[1][0]} max_ulp_gap={gap[1][1]:g}, x[nc,3] rows_differing={gap[3][0]} "
            f"max_ulp_gap={gap[3][1]:g} ({time.perf_counter() - t0:.1f} s)")
        need(same and tail_same,
             f"14a: an AMG kernel differs from its plain version ({tag}, {name})")


def amg_csr(torch, lv):
    """The level's whole matrix (diag, upper, lower) as a torch sparse CSR
    tensor: the library yardstick's operand."""
    own, nei, n = lv["own"], lv["nei"], lv["n"]
    ar = torch.arange(n, device=own.device)
    idx = torch.stack([torch.cat([own, nei, ar]), torch.cat([nei, own, ar])])
    vals = torch.cat([lv["up"], lv["lo"], lv["diag"]])
    return torch.sparse_coo_tensor(idx, vals, (n, n)).coalesce().to_sparse_csr()


def cluster_barrier_ms(torch, probe, timer, dev, threads, mode="release", blocks=16,
                       syncs=100):
    """Device ms of one cluster barrier in a cluster of ``blocks`` blocks
    of ``threads`` (cluster_sync_kernel: a launch with ``syncs`` barriers
    less one with none, replayed from a graph, over ``syncs``); ``mode``
    as probe.cluster_sync: "release" (the earlier tail's), "relaxed" (no fence:
    only its price), "one release" (this tail's barrier)."""
    state = torch.zeros(probe.CLUSTER_BLOCKS, dtype=torch.int32, device=dev)
    ms = [device_ms(torch, timer,
                    lambda n=n: probe.cluster_sync(n, threads, state, mode, blocks))
          for n in (syncs, 0)]
    return max(ms[0] - ms[1], 0.0) / syncs


def smem_load_ms(torch, probe, timer, dev, remote, steps=1000):
    """Device ms of one dependent shared-memory read in the tail's cluster
    (smem_chase_kernel: a launch of ``steps`` reads less one of none,
    replayed from a graph, over ``steps``): a block's own, or with
    ``remote`` another block's."""
    state = torch.zeros(2, dtype=torch.int32, device=dev)
    ms = [device_ms(torch, timer, lambda n=n: probe.smem_chase(n, state, remote))
          for n in (steps, 0)]
    return max(ms[0] - ms[1], 0.0) / steps


def tail_stamps(torch, dev, amg_cuda, amg_tail, args, reps):
    """{phase: device ms} of one tail launch (amg_tail's stamps: block 0's
    thread 0 reads its SM clock after each phase; the clocks are turned
    into ms by the launch's own globaltimer span over its clocks), over
    ``reps`` launches, and the mean in-kernel span; ({}, None) on the CPU."""
    rows, aggs, ops, prolong, r = args
    if dev.type != "cuda":
        return {}, None
    plan = amg_tail.tail_plan(rows, aggs, prolong, amg_cuda.TAIL_BLOCK0_ROWS)
    names = amg_tail.phases(plan)
    stamps = torch.zeros(len(names) + 2, dtype=torch.int64, device=dev)
    for _ in range(reps):
        amg_cuda.amg_tail(rows, aggs, ops, prolong, r, stamps=stamps)
    s = stamps.tolist()
    ms_per_clock = s[-2] / max(s[-1], 1) / 1e6
    return {n: s[i] * ms_per_clock / reps for i, n in enumerate(names)}, s[-2] / reps / 1e6


def load_parent_amg(parent):
    """The parent checkout's ops/amg_cuda.py (its TailParams, tail_layout
    and tail_params; its relative imports resolve to this tree's amg.py and
    fused_cuda.py, which the parent shares), as a module of its own."""
    import importlib.util

    path = os.path.join(parent, "cudaparticlesfoam_tpu_torch", "ops", "amg_cuda.py")
    spec = importlib.util.spec_from_file_location(
        "cudaparticlesfoam_tpu_torch.ops._parent_amg_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def parent_tail(torch, dev, parent, args):
    """A call of the parent's amg_tail_kernel (its library, built by
    load_parent, through its bare C entries and its own TailParams) on the
    tail ``args``, and its output."""
    import ctypes

    plib, pdir = parent
    mod = load_parent_amg(pdir)
    rows, aggs, ops, prolong, r = args
    sfx = {torch.float32: "f32", torch.float64: "f64"}[r.dtype]
    lay = mod.tail_layout([p.n for p in rows], int(rows[-1].h_offsets[-1]), r.element_size())
    x = torch.empty_like(r)
    params = mod.tail_params(rows, aggs, ops, prolong, r, x, lay)
    prep, run = getattr(plib, f"cpf_amg_tail_prepare_{sfx}"), getattr(plib, f"cpf_amg_tail_{sfx}")
    prep.argtypes, prep.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    run.restype = ctypes.c_int
    clusters = ctypes.c_int(0)
    need(prep(lay.threads, lay.smem, ctypes.addressof(clusters)) == 0 and clusters.value > 0,
         "the parent's amg_tail_prepare failed")

    def call():
        need(run(ctypes.addressof(params), lay.threads, lay.smem,
                 torch.cuda.current_stream(dev).cuda_stream) == 0, "the parent's tail failed")
        return x

    call.keep = params
    return call


def phase_amg_times(torch, dev, tag, traffic, m, h, A, gpu_line, parent=None):
    """14a's timings at the path's shapes (A's float32 operators, random
    inputs): each kernel's device ms (graph replays, device_ms) beside its
    plain version's ms and, for fv_matvec, one cuSPARSE CSR matvec of the
    same matrix (torch.mv, replayed from a graph as the kernel is, as
    library_ms); bytes, bound and share (ops/traffic.py); each kernel's
    dependent chain (traffic.AMG_CHAIN, traffic.amg_tail_chain: the earlier
    kernel, the yardstick, and this design's) and the tail's units, one
    cluster barrier and one dependent read of a block's own and of another
    block's shared memory, for its latency bound (priced with phase 6's
    load latency and launch floor in the kernel table); fv_matvec, amg_down
    and amg_up at level 0 (the largest), amg_tail at the path's split
    (amg.tail_start); for the tail also its plan (cluster levels, threads,
    staged bytes, levels staged, neighbours in another block), the cluster
    barrier at 2, 4, 8 and 16 blocks in its three forms (probe.cluster_sync),
    its phases (tail_stamps), block 0 from 512 and 1024 rows, and with ``parent``
    (the parent's library and checkout) the parent's tail on the same
    inputs in turns; the crossover: each level's down + up against the
    tail's two phases there (the tail from that level less the tail from
    the next); one V-cycle with the tail and with TAIL_ROWS = 0.  Returns
    {kernel: dict} for the kernel table."""
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda, amg_tail, probe

    timer = Timer(torch, dev)
    lvs = amg_level_cases(torch, fv, amg, m, h, A, A.diag.dtype, AMG_SEED + 1)
    e, L = A.diag.element_size(), len(h.sizes)
    sizes, nfs = [lv["n"] for lv in lvs], [lv["up"].shape[0] for lv in lvs]
    rows, aggs, ops, prolong = tail_lists(lvs)
    t = amg.tail_start(sizes, amg_cuda.TAIL_ROWS)
    l0 = lvs[0]
    rows0, d0, up0, lo0, r0 = l0["rows"], l0["diag"], l0["up"], l0["lo"], l0["r"]
    rs = [r0]
    for li in range(L):
        rs.append(amg_cuda.amg_down(rows[li], aggs[li], *ops[li], rs[li]))

    def tail_args(k):
        return rows[k:], aggs[k:], ops[k:], prolong[k:], rs[k]

    def tail_from(k):
        return lambda: amg_cuda.amg_tail(*tail_args(k))

    plan = amg_tail.tail_plan(rows[t:], aggs[t:], prolong[t:], amg_cuda.TAIL_BLOCK0_ROWS)
    lay = amg_cuda.tail_layout(plan, e)
    tc = traffic.amg_tail_chain(sizes[t:])
    tn = traffic.amg_tail_chain(sizes[t:], block0_rows=amg_cuda.TAIL_BLOCK0_ROWS)
    # the tail's units: a cluster barrier, a dependent read of another
    # block's shared memory and of a block's own
    units = dict(barrier_ms=cluster_barrier_ms(torch, probe, timer, dev, lay.threads),
                 t_dsmem_ms=smem_load_ms(torch, probe, timer, dev, True),
                 t_smem_ms=smem_load_ms(torch, probe, timer, dev, False))
    relaxed = cluster_barrier_ms(torch, probe, timer, dev, lay.threads, "relaxed")
    one = cluster_barrier_ms(torch, probe, timer, dev, lay.threads, "one release")
    ch = traffic.AMG_CHAIN
    level = dict(tail_barriers=0, dsmem_loads=0, smem_loads=0, **units)
    calls = {
        "fv_matvec": (lambda: amg_cuda.fv_matvec(rows0, d0, up0, lo0, r0),
                      lambda: amg.matvec_plain(rows0, d0, up0, lo0, r0),
                      traffic.amg_matvec(sizes[0], nfs[0], e), 1,
                      dict(level, chain=ch["matvec"]), "level 0"),
        "amg_down": (lambda: amg_cuda.amg_down(rows0, l0["aggs"], d0, up0, r0),
                     lambda: amg.down_plain(rows0, l0["aggs"], d0, up0, r0),
                     traffic.amg_down(sizes[0], sizes[1], nfs[0], e), t,
                     dict(level, chain=ch["down"]), "level 0"),
        "amg_up": (lambda: amg_cuda.amg_up(rows0, d0, up0, r0, l0["agg"], l0["xc"]),
                   lambda: amg.up_plain(rows0, d0, up0, r0, l0["agg"], l0["xc"]),
                   traffic.amg_up(sizes[0], sizes[1], nfs[0], e), t,
                   dict(level, chain=ch["up"]), "level 0"),
        # the earlier design's chain (the yardstick of the same work) and this one's
        "amg_tail": (tail_from(t), lambda: amg.tail_plain(*tail_args(t)),
                     traffic.amg_tail(sizes[t:], nfs[t:], e), 1,
                     dict(chain=tc["l2"], tail_barriers=tc["barriers"], dsmem_loads=tc["dsmem"],
                          smem_loads=tc["smem"], design_chain=tn["l2"],
                          design_barriers=tn["barriers"], design_dsmem_loads=tn["dsmem"],
                          design_smem_loads=tn["smem"], one_release_barrier_ms=one, **units),
                     f"levels {t}..{L} ({amg_cuda.TAIL_BLOCKS} blocks x {lay.threads} threads, "
                     f"{lay.smem} B of shared memory a block)"),
    } if L else {}
    out = {}
    csr = amg_csr(torch, l0)
    for key, (kern, plain, tr, per_it, chain, where) in calls.items():
        ms = device_ms(torch, timer, kern)
        plain_ms = time_calls(timer, plain, lambda: None, 3)
        res = dict(ms=ms, plain_ms=plain_ms, bytes=tr.bytes, bound_ms=tr.bound_ms,
                   bound_by=tr.bound_by, share=tr.bound_ms / ms, library_ms=None,
                   copy_ms=copy_ms(torch, dev, timer, tr.bytes), launches_per_cycle=per_it,
                   launches_per_cg_iteration=per_it, **chain)
        extra = f" chain={chain['chain']}"
        if key == "fv_matvec":
            res["batch_ms"] = batch_ms(timer, kern)
            res["library_ms"] = device_ms(torch, timer, lambda: torch.mv(csr, r0))
            res["library_back_to_back_ms"] = batch_ms(timer, lambda: torch.mv(csr, r0))
            lib_err = float((torch.mv(csr, r0) - kern()).abs().max())
            extra += (f" kernel_back_to_back_ms={res['batch_ms']:.5f} library_ms="
                      f"{res['library_ms']:.5f} (cuSPARSE CSR torch.mv replayed from a graph, "
                      f"as the kernel; back to back {res['library_back_to_back_ms']:.5f}; "
                      f"|library - kernel| max {lib_err:.3e}; kernel "
                      f"{'slower' if ms > res['library_ms'] else 'faster'})")
        elif key == "amg_tail":
            res.update(cluster_levels=plan.cluster, staged_bytes=lay.smem,
                       vector_bytes=lay.vectors, levels_staged=sum(lay.stage),
                       remote_terms=plan.remote_terms, cluster_terms=plan.cluster_terms)
            extra += (f" earlier design: barriers={tc['barriers']} dsmem_loads={tc['dsmem']} "
                      f"smem_loads={tc['smem']} | this design: cluster_levels={plan.cluster} "
                      f"(block 0 from {amg_cuda.TAIL_BLOCK0_ROWS} rows) barriers="
                      f"{tn['barriers']} l2_loads={tn['l2']} dsmem_loads={tn['dsmem']} "
                      f"smem_loads={tn['smem']} | cluster_barrier_ms={units['barrier_ms']:.5f} "
                      f"(release/acquire in every thread; a relaxed arrive {relaxed:.5f}; warp 0 "
                      f"releasing {one:.5f}) dsmem_load_ms={units['t_dsmem_ms']:.3e} "
                      f"smem_load_ms={units['t_smem_ms']:.3e} | staged_bytes_a_block={lay.smem} "
                      f"(vectors {lay.vectors}) levels_staged={sum(lay.stage)}/{len(lay.stage)} "
                      f"neighbours_in_another_block={plan.remote_terms}/{plan.cluster_terms}")
        out[key] = res
        log(f"[amg-times] {gpu_line} | {tag}, float32, {key} at {where} "
            f"(rows={sizes[t] if key == 'amg_tail' else sizes[0]}): ms={ms:.5f} "
            f"plain_ms={plain_ms:.4f} bytes={tr.bytes} bound_ms={tr.bound_ms:.5f} "
            f"({tr.bound_by}) share={tr.bound_ms / ms:.3f} "
            f"launches_per_cg_iteration={per_it}{extra}")
    if not L:
        return out
    reps = BATCH if dev.type == "cuda" else 2      # the rehearsal's host loops: few
    tb = out["amg_tail"]
    # the tail's phases, from the clocks block 0 reads after each
    split, span = tail_stamps(torch, dev, amg_cuda, amg_tail, tail_args(t), reps)
    tb["phase_ms"] = split
    log(f"[amg-times] {gpu_line} | {tag}, float32, amg_tail phases (block 0's clock after "
        f"each, {reps} launches): "
        + (" ".join(f"{n}={v:.5f}" for n, v in split.items()) + f" | in-kernel span "
           f"{span:.5f} ms of the kernel's {tb['ms']:.5f}" if split else "not measured (cpu)"))
    # the cluster barrier by cluster size and form, at the tail's threads
    bars = {(mode, n): cluster_barrier_ms(torch, probe, timer, dev, lay.threads, mode, n)
            for mode in probe.BARRIER_MODES for n in (2, 4, 8, 16)}
    tb["barrier_by_blocks_ms"] = {f"{mode}, {n}": v for (mode, n), v in bars.items()}
    log(f"[amg-times] {gpu_line} | {tag}, cluster barrier ms at {lay.threads} threads a block "
        f"by cluster size: " + " | ".join(
            f"{mode}: " + " ".join(f"{n}={bars[(mode, n)]:.5f}" for n in (2, 4, 8, 16))
            for mode in probe.BARRIER_MODES))
    # block 0 from 512 and from 1024 rows (the plan's threshold), or the
    # layout's reason where that tail cannot stage every level
    b0, said = {}, {}
    for n in (512, 1024):
        run = lambda n=n: amg_cuda.amg_tail(*tail_args(t), block0_rows=n)  # noqa: E731
        try:
            b0[n] = device_ms(torch, timer, run, reps=reps)
            said[n] = f"{b0[n]:.5f} ms"
        except ValueError as exc:
            b0[n], said[n] = None, f"raises ({exc})"
    tb["block0_rows_ms"] = b0
    log(f"[amg-times] {gpu_line} | {tag}, float32, amg_tail with block 0 from: "
        + " ".join(f"{n} rows (cluster levels {amg_tail.cluster_levels(sizes[t:], n)}) {v}"
                   for n, v in said.items())
        + f" | TAIL_BLOCK0_ROWS={amg_cuda.TAIL_BLOCK0_ROWS}")
    if parent is not None:
        theirs = parent_tail(torch, dev, parent, tail_args(t))
        mine_x, their_x = tail_from(t)(), theirs()
        turns = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            turns[who].append(device_ms(torch, timer, theirs if who == "parent"
                                        else tail_from(t), reps=reps))
        same = bitwise_equal(torch, mine_x, their_x)
        tb["parent_ms"] = sum(turns["parent"]) / 2
        tb["parent_turns_ms"], tb["this_turns_ms"] = turns["parent"], turns["this"]
        log(f"[amg-times] {gpu_line} | {tag}, float32, amg_tail against the parent's on the same "
            f"inputs, in turns (parent, this, this, parent): parent_ms=("
            + ", ".join(f"{v:.5f}" for v in turns["parent"]) + ") this_ms=("
            + ", ".join(f"{v:.5f}" for v in turns["this"]) + f") identical={int(same)}")
        need(same, f"14a: this tree's tail differs from the parent's ({tag})")
    # the crossover: a level's two kernels against the tail's two phases there
    fits = {k: tail_fits(amg_cuda, rows[k:], aggs[k:], prolong[k:], e)[0] is not None
            for k in range(L, -1, -1)}
    tail_ms = {k: device_ms(torch, timer, tail_from(k), reps=reps) if fits[k] else None
               for k in range(L, -1, -1)}
    cross, kern_sum, kern_bound = [], 0.0, 0.0
    for li in range(L):
        lv = lvs[li]
        pair = (device_ms(torch, timer, lambda lv=lv: amg_cuda.amg_down(
                    lv["rows"], lv["aggs"], lv["diag"], lv["up"], lv["r"]), reps=min(reps, 50))
                + device_ms(torch, timer, lambda lv=lv: amg_cuda.amg_up(
                    lv["rows"], lv["diag"], lv["up"], lv["r"], lv["agg"], lv["xc"]),
                    reps=min(reps, 50)))
        if li < t:
            kern_sum += pair
            kern_bound += (traffic.amg_down(sizes[li], sizes[li + 1], nfs[li], e).bound_ms
                           + traffic.amg_up(sizes[li], sizes[li + 1], nfs[li], e).bound_ms)
        ph = None if tail_ms[li] is None else tail_ms[li] - tail_ms[li + 1]
        cross.append((li, sizes[li], pair, ph))
    sweep0 = device_ms(torch, timer, lambda: amg_cuda.amg_tail([rows[-1]], [], [ops[-1]], [],
                                                                rs[L], sweeps=0), reps=reps)
    wins = [n for _, n, pair, ph in cross if ph is not None and ph < pair]
    # the split a V-cycle is cheapest at: the level kernels above it, the tail below
    cost = {k: sum(c[2] for c in cross[:k]) + tail_ms[k] for k in range(L + 1) if fits[k]}
    best = min(cost, key=cost.__getitem__)
    log(f"[amg-times] {gpu_line} | {tag}, float32, crossover (device ms, graph replays): "
        + " ".join(f"level {li} rows={n}: down+up={pair:.5f} tail_phases="
                   + ("n/a" if ph is None else f"{ph:.5f}") for li, n, pair, ph in cross)
        + f" | coarsest alone {tail_ms[L]:.5f}, with no sweep {sweep0:.5f}: a sweep "
        f"{(tail_ms[L] - sweep0) / amg.COARSEST_SWEEPS:.5f} | the tail cheaper at {len(wins)} "
        f"of {L} levels | the cheapest split t={best} (tail from {sizes[best]} rows): "
        f"{cost[best]:.5f} ms; TAIL_ROWS={amg_cuda.TAIL_ROWS} splits at t={t}: {cost[t]:.5f} ms")
    with TailRows(0):
        split0 = device_ms(torch, timer, lambda: fv.vcycle_levels(rows, aggs, ops, prolong, r0),
                           reps=reps)
    vcyc = device_ms(torch, timer, lambda: fv.vcycle_levels(rows, aggs, ops, prolong, r0),
                     reps=reps)
    log(f"[amg-times] {gpu_line} | {tag}, float32, one V-cycle: {2 * t + 1} launches, "
        f"down + up over {t} "
        f"levels {kern_sum:.5f} ms + tail {tb['ms']:.5f} ms = {kern_sum + tb['ms']:.5f} ms; "
        f"byte bounds {kern_bound + tb['bound_ms']:.5f} ms | vcycle_levels replayed: "
        f"tail {vcyc:.5f} ms, TAIL_ROWS=0 ({2 * L + 1} launches) {split0:.5f} ms")
    tb.update(vcycle_ms=vcyc, vcycle_split0_ms=split0, split=t, best_split=best)
    return out


def phase_amg_graph(torch, dev, tag, m, h, A, b, x0, tol, max_iter, gpu_line):
    """14b: one whole pressure solve (amg_cg_solve, the path's tolerance and
    cap) with the CG loop replayed from a CUDA graph and eagerly: x and
    |r|/|b| bit for bit, the same CG count, one replay an iteration; the
    solve's ms both ways and the capture's ms."""
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.parallel import flowshard as fs

    timer = Timer(torch, dev)
    res = {}
    for mode in ("graph", "eager"):
        with AmgMode(fv, fs, mode):
            fv.amg_cg_solve(m, h, A, b, x0, tol, max_iter)        # warm
            rep0, cap0 = fv._pcg.graph_replays, fv._pcg.graph_captures
            timer.start()
            x, r, it = fv.amg_cg_solve(m, h, A, b, x0, tol, max_iter)
            ms = timer.stop()
            res[mode] = (x, r, it, ms, fv._pcg.graph_replays - rep0,
                         fv._pcg.graph_captures - cap0)
    (xg, rg, ig, msg, reps, caps), (xe, re_, ie, mse, _, _) = res["graph"], res["eager"]
    same = bitwise_equal(torch, xg, xe) and bitwise_equal(torch, rg, re_) and ig == ie
    cap_ms = None
    if dev.type == "cuda":
        levels = fv.amg_coarse_ops(m, h, A)
        r = b - fv.matvec(m, A, x0)
        p = fv.amg_vcycle(m, h, A, levels, r)
        rz, nb = fv._dot(r, p), torch.sqrt(fv._dot(b, b)) + 1e-300
        go = torch.sqrt(fv._dot(r, r)) / nb > tol
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        fv._cg_graph(m, A, x0.clone(), r, p, rz, nb, go,
                     lambda q: fv.amg_vcycle(m, h, A, levels, q), tol)
        torch.cuda.synchronize()
        cap_ms = (time.perf_counter() - h0) * 1e3
    # one V-cycle through the wrappers: t down, the tail, t up
    from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda

    before = {f.__name__: f.launches for f in amg_cuda.WRAPPERS}
    fv.amg_vcycle(m, h, A, fv.amg_coarse_ops(m, h, A), b)
    vc = {f.__name__: f.launches - before[f.__name__] for f in amg_cuda.WRAPPERS}
    L = len(h.sizes)
    t = amg.tail_start([m.n_cells] + list(h.sizes), amg_cuda.TAIL_ROWS)
    log(f"[amg-graph] {gpu_line} | {tag}: one pressure solve ({A.diag.dtype}) graph = eager "
        f"bit for bit: {int(same)} cg_iterations graph={ig} eager={ie} graph_replays={reps} "
        f"graph_captures={caps} solve_ms graph={msg:.3f} eager={mse:.3f} "
        f"capture_ms={unmeasured(cap_ms, '%.3f')} (host, capture and instantiate) | one "
        f"V-cycle's launches {vc} (2t + 1 = {2 * t + 1}, t = {t} of L = {L} levels above "
        f"the coarsest; level by level 2L + 1 = {2 * L + 1})")
    need(dev.type != "cuda" or vc == {"fv_matvec": 0, "amg_down": t, "amg_up": t,
                                      "amg_tail": 1},
         f"14b: a V-cycle launched {vc}, not t = {t} downs and ups and one tail ({tag})")
    need(same and ig == ie, f"14b: graph and eager pressure solves differ ({tag})")
    need(dev.type != "cuda" or (reps == ig and caps == (1 if ig else 0)),
         f"14b: {reps} replays and {caps} captures for {ig} CG iterations ({tag})")


def phase_amg_modes(torch, dev, tag, m, h, A, b, x0, tol, max_iter, whole, unit, gpu_line):
    """14c: per V-cycle, per CG iteration (one pressure solve's, over its
    iterations) and per ``unit`` (``whole``: a SIMPLE iteration or a
    PIMPLE step), the device ms, the host's ms to issue, the kernels and
    the launch calls (torch.profiler; a graph replay is one
    cudaGraphLaunch), for the port's path (graph) and the level-by-level split (graph
    2L+1) in turns, the kernels with the CG loop eager (eager), and the
    op-by-op path (op-by-op)."""
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.parallel import flowshard as fs

    levels = fv.amg_coarse_ops(m, h, A)
    out = []
    for mode in AMG_TURNS:
        with AmgMode(fv, fs, mode):
            vc = measure_part(torch, dev, lambda: fv.amg_vcycle(m, h, A, levels, b))
            its = fv.amg_cg_solve(m, h, A, b, x0, tol, max_iter)[2]
            cg = measure_part(torch, dev, lambda: fv.amg_cg_solve(m, h, A, b, x0, tol, max_iter))
            wh = measure_part(torch, dev, whole)
        per = lambda r, k: None if r[k] is None else r[k] / max(its, 1)  # noqa: E731
        out.append((mode, its, vc, cg, wh))
        log(f"[amg-modes] {gpu_line} | {tag}, {mode}: per V-cycle ms={vc['ms']:.4f} "
            f"host_issue_ms={vc['host_ms']:.4f} kernels={unmeasured(vc['kernels'])} "
            f"launch_calls={unmeasured(vc['launch_calls'])} | per CG iteration "
            f"({its} in the solve) ms={cg['ms'] / max(its, 1):.4f} "
            f"kernels={unmeasured(per(cg, 'kernels'), '%.1f')} "
            f"launch_calls={unmeasured(per(cg, 'launch_calls'), '%.1f')} | per {unit} "
            f"ms={wh['ms']:.3f} host_issue_ms={wh['host_ms']:.3f} "
            f"kernels={unmeasured(wh['kernels'])} launch_calls={unmeasured(wh['launch_calls'])} "
            f"kernel_busy_ms={unmeasured(wh['busy_ms'], '%.3f')}")
    return out


def shard_tail_parity(torch, fv, fs, amg, amg_cuda, lam, m, mask, diag0, off0, r, errs,
                      gpu_line):
    """14a on shard 0's local hierarchy: the tail with valid (the clipped
    prolongation times agg_valid) against tail_plain at every split,
    float32 and float64, bit for bit."""
    t = lam.shard[0]
    for dtype in (torch.float32, torch.float64):
        d0, o0 = diag0.to(dtype), off0.to(dtype)
        levels = fs._local_coarse_ops(lam, 0, m, d0, o0)
        rows = [amg.row_plan(m.n_cells, m.own_i, m.neighbour)] + [
            amg.row_plan(d_.shape[0], o, ne) for (d_, _), o, ne in zip(levels, t["owners"],
                                                                       t["neighs"])]
        aggs = [amg.agg_plan(nc, a) for (nc, _), a in zip(lam.sizes, t["aggs"])]
        prolong = [(a, v.to(dtype)) for a, v in zip(t["aggs_c"], t["agg_valid"])]
        same, err, checks, too_big, unstaged, why = tail_splits(
            torch, amg, amg_cuda, rows, aggs, [(d0, o0)] + levels, prolong,
            torch.where(mask, r, 0.0).to(dtype))
        errs["amg_tail"] = max(errs.get("amg_tail", 0.0), err)
        log(f"[amg-parity] {gpu_line} | TJunction shard 0's local hierarchy (valid), "
            f"{str(dtype).split('.')[1]}: sizes={[m.n_cells] + [n for n, _ in lam.sizes]} "
            f"amg_tail at every split: checks={checks} kernel_eq_plain={int(same)} "
            f"splits_too_big_for_shared_memory={too_big} "
            f"splits_with_a_level_read_from_global_memory={unstaged}"
            + (f" (first raise: {why})" if why else ""))
        need(same, f"14a: the tail differs from its plain version on a shard ({dtype})")


def phase_amg_sharded(torch, dev, sharded, dt_e, kernels_step, errs, gpu_line):
    """14a's shard check (shard_tail_parity) and 14c for 13b: the 4-shard
    step with the kernels and the tail (its lockstep CG loop eager; that
    loop's graph is later work) beside the level-by-level split (2L+1) and the
    op-by-op path: one local V-cycle of shard 0 (amg_system's matrix on its
    mesh, masked as the step masks it), and one whole sharded step
    profiled: ms, kernels, CG iterations and kernels per CG iteration.  The
    kernels' step is 13b's profiled one (``kernels_step``); the others are
    the steps after it."""
    from cudaparticlesfoam_tpu_torch.models import fv
    from cudaparticlesfoam_tpu_torch.ops import amg, amg_cuda
    from cudaparticlesfoam_tpu_torch.parallel import flowshard as fs

    lam, sh = sharded.lamg, sharded.smesh.shards[0]
    m = sh.m
    A, r = amg_system(torch, fv, m, m.dtype, AMG_SEED + 2)
    off0 = A.upper * lam.shard[0]["off_mask"]
    diag0 = torch.where(sh.mask, fv.index_sum(m.n_cells, [(m.own_i, -off0),
                                                          (m.neighbour, -off0)], out=A.diag), 1.0)
    shard_tail_parity(torch, fv, fs, amg, amg_cuda, lam, m, sh.mask, diag0, off0, r, errs,
                      gpu_line)
    levels = fs._local_coarse_ops(lam, 0, m, diag0, off0)
    r0 = torch.where(sh.mask, r, 0.0)
    steps = {"eager": kernels_step}
    for mode in ("eager", "eager 2L+1", "op-by-op"):
        with AmgMode(fv, fs, mode):
            vc = measure_part(torch, dev,
                              lambda: fs._local_vcycle(lam, 0, m, diag0, off0, levels, r0))
            if mode not in steps:
                steps[mode] = profile_kernels(torch, dev, lambda: sharded.advance(dt_e))
        kernels, busy, ms, its = steps[mode]
        n_it = sum(its)
        per = None if kernels is None else kernels / max(n_it, 1)
        log(f"[amg-sharded] {gpu_line} | TJunction, {sharded.m.n_cells} cells on "
            f"{sharded.smesh.n_dev} shards, float32, {mode}: one local V-cycle of shard 0 "
            f"({lam.n_levels} levels) ms={vc['ms']:.4f} host_issue_ms={vc['host_ms']:.4f} "
            f"kernels={unmeasured(vc['kernels'])} | one sharded step "
            f"ms={unmeasured(ms, '%.1f')} kernels={unmeasured(kernels)} "
            f"kernel_busy_ms={unmeasured(busy, '%.1f')} cg_iterations={its} "
            f"kernels_per_cg_iteration={unmeasured(per, '%.1f')}")


def phase_amg(torch, dev, traffic, tag, split, errs, unit, gpu_line, parent=None):
    """Phase 14 on a flow path's state (10c's or 11d's split: its mesh,
    hierarchy, pressure matrix and right-hand side): 14a's checks at every
    level and its timings (with ``parent``, the parent's tail beside this
    one), 14b, 14c.  Returns 14a's timings."""
    m, h, A, b, x0 = (split[k] for k in ("m", "h", "A", "b", "x0"))
    phase_amg_parity(torch, dev, tag, m, h, A, errs, gpu_line)
    times = phase_amg_times(torch, dev, tag, traffic, m, h, A, gpu_line, parent)
    phase_amg_graph(torch, dev, tag, m, h, A, b, x0, split["tol"], split["max_iter"], gpu_line)
    phase_amg_modes(torch, dev, tag, m, h, A, b, x0, split["tol"], split["max_iter"],
                    split["whole"], unit, gpu_line)
    return times


def phase_amg_boxes(torch, dev, tmp, rehearse, errs, gpu_line):
    """14a on boxes of 65,536 and 65,499 cells (the rehearsal: 256 and 231)
    with amg_system's matrix: every level, both dtypes; and the tail on the
    16 x 16 x 8 box with block 0 from 32 rows (phase_amg_first)."""
    from cudaparticlesfoam_tpu_torch.models import fv

    phase_amg_first(torch, dev, tmp, errs, gpu_line)
    for n, cells in (AMG_BOXES_REHEARSAL if rehearse else AMG_BOXES).items():
        m = fv.fv_mesh(amg_box(tmp, cells), dtype=torch.float32, device=dev)
        need(m.n_cells == n, f"the box has {m.n_cells} cells, not {n}")
        h = fv.build_amg(m, min_coarse=20 if rehearse else 200)
        A, _ = amg_system(torch, fv, m, torch.float32, AMG_SEED)
        phase_amg_parity(torch, dev, f"box {cells[0]}x{cells[1]}x{cells[2]} ({n} cells)", m,
                         h, A, errs, gpu_line)


def phase_amg_alone(torch, dev, traffic, rehearse, gpu_line, parent=None):
    """``--phase amg-tail``: 14a alone, on amg_system's matrices and no flow
    solve: each kernel at every level and the tail at every split of
    pitzDaily's and the TJunction's hierarchies (the rehearsal: an 8 x 8 x
    4 box's) with their [amg-times] lines (with ``parent``, the parent's
    tail beside this one), then the two boxes and the 16 x 16 x 8 box
    (phase_amg_boxes).  Returns the largest |kernel - plain| a kernel."""
    from cudaparticlesfoam_tpu_torch.io import blockmesh
    from cudaparticlesfoam_tpu_torch.models import fv

    errs = {}
    with tempfile.TemporaryDirectory(prefix="cpf_amg_") as tmp:
        if rehearse:
            cases = [("box 8x8x4 (256 cells)", lambda: amg_box(tmp, (8, 8, 4)), 20)]
        else:
            cases = [(f"{name} (amg_system)", lambda d=d: blockmesh.generate(
                          os.path.join(d, "system", "blockMeshDict")), 200)
                     for name, d in (("pitzDaily", PITZ), ("TJunction", TJUNC))]
        for tag, mesh, coarse in cases:
            t0 = time.perf_counter()
            m = fv.fv_mesh(mesh(), dtype=torch.float32, device=dev)
            h = fv.build_amg(m, min_coarse=coarse)
            A, _ = amg_system(torch, fv, m, torch.float32, AMG_SEED)
            log(f"[setup] {tag}: {m.n_cells} cells, levels {[m.n_cells] + list(h.sizes)} "
                f"({time.perf_counter() - t0:.1f} s)")
            phase_amg_parity(torch, dev, tag, m, h, A, errs, gpu_line)
            phase_amg_times(torch, dev, tag, traffic, m, h, A, gpu_line, parent)
            del m, h, A
        phase_amg_boxes(torch, dev, tmp, rehearse, errs, gpu_line)
    return errs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at small sizes on the CPU (plain versions "
                         "only); prints no device result and exits 2")
    ap.add_argument("--parent", metavar="DIR",
                    help="also build the kernels of the checkout in DIR (another commit) and "
                         "time its rare kernels (phase 7) and its AMG tail (phase 14) against "
                         "this tree's on the same inputs")
    ap.add_argument("--phase", choices=("amg-tail",),
                    help="after the build run only this part and print the last line: "
                         "amg-tail is 14a alone on amg_system matrices (phase_amg_alone); "
                         "the full run stays the gate")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, HERE)
    import cudaparticlesfoam_tpu_torch as cpt
    from cudaparticlesfoam_tpu_torch import convert
    from cudaparticlesfoam_tpu_torch import mesh as tmesh
    from cudaparticlesfoam_tpu_torch.ops import (_build, fused, fused_convex, fused_cuda, probe,
                                                 traffic)

    need("jax" not in sys.modules, "the port imported jax")
    need(os.path.exists(GOLDEN) and os.path.exists(INPUTS), "golden fixtures missing")

    if args.rehearse:
        need(not args.parent, "--parent needs the card")
        dev = torch.device("cpu")
        sizes = dict(parity=(6, 3072), stats=20_000, slice=(12, 8_000, 8), simple=3,
                     admit=(1, 3, 4, 15, 16, 17, 8155, 8192, 20_000), driver_warm=20, rk4=8,
                     rk4_parity=1024, flow_warm=1, dyn=(6, 3072), part=(2, 4))
        gpu_line = "cpu rehearsal"
        kind = "cpu"
    else:
        if not torch.cuda.is_available():
            print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        sizes = dict(parity=(16, 65_536), stats=1_000_000, slice=(55, 1_000_000, 200), simple=5,
                     admit=(1, 3, 4, 15, 16, 17, 65_499, 65_536, 1_000_000, 4_000_001),
                     driver_warm=100, rk4=100, rk4_parity=65_536, flow_warm=5,
                     dyn=(16, 65_536), part=(10, 20))
        kind = torch.cuda.get_device_name(0)
        gpu_line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        log(f"[device] torch={torch.__version__} cuda={torch.version.cuda} "
            f"name={kind} count={torch.cuda.device_count()}")
        log(gpu_line)
        t0 = time.perf_counter()
        secs = _build.build_seconds()
        log(f"[build] nvcc sm_90a --fmad=false build+load_s={secs:.2f} "
            f"(phase {time.perf_counter() - t0:.2f} s, {len(_build.sources())} sources in "
            f"parallel)")
        lines = ptxas_lines(_build.ptxas_report())
        for line in lines:
            log(f"[build] {line}")
        register_report(_build, lines)

    if args.phase == "amg-tail":
        parent = (load_parent(_build, args.parent)[0], args.parent) if args.parent else None
        errs = phase_amg_alone(torch, dev, traffic, args.rehearse, gpu_line, parent)
        log(f"[amg-alone] {gpu_line} | max_abs_err {errs}")
        if args.rehearse:
            log("rehearsal done: plain versions on the CPU, no device result")
            return 2
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
        return 0

    errs = {"stream": 0.0, "rare": 0.0, "convex_stream": 0.0, "convex_rare": 0.0, "macro": 0.0,
            "hop_admit": 0.0, "stream_pk": 0.0, "rare_pk": 0.0, "stream_tutorial": 0.0,
            "rare_tutorial": 0.0}
    counts = {}
    nside, n = sizes["parity"]
    phase_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs)
    phase_convex_parity(torch, cpt, fused, fused_convex, fused_cuda, tmesh, convert, dev,
                        nside, n, errs)
    phase_noise(torch, cpt, fused, fused_convex, fused_cuda, tmesh, convert, dev, nside, n,
                sizes["stats"], errs)
    phase_admit_sizes(torch, fused, fused_cuda, dev, sizes["admit"], errs)
    phase_compact(torch, cpt, fused, fused_convex, fused_cuda, tmesh, convert, dev, nside, n,
                  errs)
    phase_macro(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs)
    phase_pk_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs)
    phase_golden(torch, cpt, convert, fused_cuda, dev)
    rares = RareStudy(torch, dev, load_parent(_build, args.parent) if args.parent else None)
    launches, times, med, slice_setup = phase_slice(torch, cpt, fused, fused_cuda, tmesh, dev,
                                                    *sizes["slice"], errs, counts, rares,
                                                    gpu_line)
    pack_table = phase_pack(torch, cpt, fused, fused_convex, fused_cuda, dev, nside, n,
                            slice_setup, gpu_line)
    for k in pack_table:     # the main path's launches: phase 5's three calls
        pack_table[k]["launches"] = launches[k]
    c_launches, c_times, _ = phase_convex_slice(torch, cpt, fused, fused_convex, fused_cuda,
                                                dev, slice_setup, sizes["slice"][2], errs,
                                                counts, rares, gpu_line)
    launches.update(c_launches)
    times.update(c_times)
    m_launches, m_times = phase_macro_slice(torch, cpt, fused, fused_convex, fused_cuda, dev,
                                            slice_setup, sizes["slice"][2], med, errs, counts,
                                            gpu_line)
    times.update(m_times)
    for convex in (False, True):
        times.update(phase_compact_slice(torch, cpt, fused, fused_convex, fused_cuda, dev,
                                         slice_setup, sizes["slice"][2], convex, errs, counts,
                                         gpu_line))
    pk_launches, pk_times = phase_pk_slice(torch, cpt, fused, fused_cuda, tmesh, dev,
                                           sizes["slice"][0], slice_setup, sizes["slice"][2],
                                           errs, counts, rares, gpu_line)
    times.update(pk_times)
    phase_simple(torch, cpt, fused_cuda, tmesh, convert, dev, nside, n, sizes["simple"],
                 gpu_line)
    # phase 9: RK4 on the cached engine, the duct oracle
    phase_rk4_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside,
                     sizes["rk4_parity"], errs)
    phase_rk4_simple(torch, cpt, fused_cuda, tmesh, convert, dev, nside, n, sizes["simple"],
                     gpu_line)
    phase_duct(torch, cpt, fused_cuda, dev, DUCT_LANES, gpu_line)
    rk4_launches, rk4_times = phase_rk4_slice(torch, cpt, fused, fused_cuda, tmesh, dev,
                                              sizes["slice"][0], slice_setup, sizes["rk4"],
                                              errs, counts, rares, gpu_line)
    times.update(rk4_times)
    # phase 8, the uncoupled driver (before phase 6, whose bounds take 8c's rows)
    with tempfile.TemporaryDirectory(prefix="cpf_driver_") as tmp:
        phase_driver_anchor(torch, fused, fused_cuda, dev, os.path.join(tmp, "anchor"), gpu_line)
        case_dir, tut_launches, tut = phase_driver_tutorial(
            torch, dev, os.path.join(tmp, "tutorial"), args.rehearse, gpu_line)
        times.update(phase_driver_cycle(torch, cpt, fused, fused_cuda, dev, case_dir,
                                        sizes["driver_warm"], errs, counts, rares, gpu_line))
    # phase 10, the steady-flow solver and the tutorial's Allrun on its field
    with tempfile.TemporaryDirectory(prefix="cpf_flow_") as tmp:
        phase_flow_parity(torch, dev, os.path.join(tmp, "parity"), args.rehearse, gpu_line)
        flow_case, t_write, pitz_launches = phase_flow_tutorial(
            torch, dev, os.path.join(tmp, "allrun"), args.rehearse, gpu_line, tut)
        split = phase_flow_split(torch, dev, flow_case, t_write, gpu_line, sizes["flow_warm"])
        # phase 14 on pitzDaily (10c's state) and on the boxes
        parent_amg = (rares.parent[0], args.parent) if args.parent else None
        amg_times = {"pitz": phase_amg(torch, dev, traffic, "pitzDaily", split, errs,
                                       "SIMPLE iteration", gpu_line, parent_amg)}
        phase_amg_boxes(torch, dev, tmp, args.rehearse, errs, gpu_line)
    # phase 11, the coupled solver and the TJunction through the kernels
    errs.update(stream_tjunction=0.0, rare_tjunction=0.0)
    with tempfile.TemporaryDirectory(prefix="cpf_coupled_") as tmp:
        phase_pimple_parity(torch, dev, os.path.join(tmp, "parity"), gpu_line)
        phase_dynamic_mesh(torch, cpt, fused, fused_cuda, tmesh, dev, os.path.join(tmp, "dyn"),
                           *sizes["dyn"], errs, gpu_line)
        tj_case, tj_launches, tj = phase_tjunction(torch, dev, os.path.join(tmp, "tj"),
                                                   args.rehearse, gpu_line)
        trun = tjunction_after_step1(torch, dev, tj_case)
        tcase, tflow, tst, tcfg = trun.case, trun.flow, trun.state, trun.cfg
        times.update(phase_tjunction_cycle(torch, fused, fused_cuda, dev, tcase, tst, tcfg, errs,
                                           counts, rares, gpu_line))
        split = phase_pimple_split(torch, dev, tcase, tflow, gpu_line)
        amg_times["tj"] = phase_amg(torch, dev, traffic, "TJunction", split, errs, "PIMPLE step",
                                    gpu_line, parent_amg)
        del split
        phase_tjunction_trace(torch, dev, trun, tmp, gpu_line)
        del tflow, tst
        trun.flow = trun.state = trun.probes = trun.scalar = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # phase 13, the domain-decomposed flow solve and the Allrun-parallel
        # (after 11, on 11c's case and phase 11's loaded tet mesh; before 12)
        errs.update(stream_tjunction_par=0.0, rare_tjunction_par=0.0)
        t13 = [time.perf_counter()]
        phase_flowshard_parity(torch, dev, os.path.join(tmp, "shard"), args.rehearse, gpu_line)
        t13.append(time.perf_counter())
        tjp_launches, _ = phase_tj_parallel_cli(torch, dev, tj_case, tmp, args.rehearse,
                                                gpu_line)
        t13.append(time.perf_counter())
        times.update(phase_tj_parallel_fields(torch, fused, fused_cuda, dev, trun, errs,
                                              counts, rares, gpu_line))
        del tcase, trun
        t13.append(time.perf_counter())
        phase_dryrun(torch, dev, gpu_line)
        t13.append(time.perf_counter())
        parts = np.diff(t13)
        log(f"[flowshard] phase 13 took {t13[-1] - t13[0]:.1f} s (bound {TJP_BOUND_S} s on the "
            f"card): 13a {parts[0]:.1f} s, 13b CLI {parts[1]:.1f} s, 13b in process + 13c "
            f"{parts[2]:.1f} s, 13d {parts[3]:.1f} s")
        if dev.type == "cuda":
            need(t13[-1] - t13[0] <= TJP_BOUND_S, f"phase 13 took {t13[-1] - t13[0]:.0f} s")
            torch.cuda.empty_cache()

    # phase 12, the multi-device particle strategies and rare_kernel<remote>
    from cudaparticlesfoam_tpu_torch.parallel import auto, partition, sharding

    errs.update(stream_dp=0.0, rare_dp=0.0, rare_remote=0.0, rare_pk_remote=0.0)
    t12 = time.perf_counter()
    phase_remote_parity(torch, cpt, fused, fused_cuda, tmesh, convert, partition, dev, nside, n,
                        errs, args.rehearse)
    dp_launches, dp_times = phase_dp(torch, cpt, fused, fused_cuda, sharding, auto, dev,
                                     slice_setup, sizes["slice"][2], *sizes["part"], errs,
                                     counts, rares, gpu_line)
    times.update(dp_times)
    part_launches, part_times = phase_partitioned(
        torch, cpt, fused, fused_cuda, tmesh, partition, sharding, dev, sizes["slice"][0],
        slice_setup, sizes["slice"][2], *sizes["part"], errs, counts, rares, gpu_line)
    times.update(part_times)
    with tempfile.TemporaryDirectory(prefix="cpf_parallel_") as tmp:
        phase_drivers_parallel(torch, dev, tmp, args.rehearse, gpu_line)
    log(f"[parallel] phase 12 took {time.perf_counter() - t12:.1f} s")

    # launches per sub-step of each kernel on its own path (3 timed runs)
    steps = 3 * sizes["slice"][2]
    per_cycle = {
        "stream": launches["stream"] / steps, "rare": launches["rare"] / steps,
        "convex_stream": launches["convex_stream"] / steps,
        "convex_rare": launches["convex_rare"] / steps,
        "macro": (m_launches["macro_stream"] + m_launches["macro_crossers"]) / steps,
        "hop_admit": m_launches["hop_admit"] / steps,
        "stream_pk": pk_launches["stream_pk"] / steps, "rare_pk": pk_launches["rare_pk"] / steps}
    # the tutorial run of phase 8b: one stream and one rare launch a cycle (checked there)
    per_cycle["stream_tutorial"] = per_cycle["rare_tutorial"] = 1.0
    # the TJunction runs of phases 11c and 13b: one stream and one rare launch a
    # cycle (checked there)
    per_cycle["stream_tjunction"] = per_cycle["rare_tjunction"] = 1.0
    per_cycle["stream_tjunction_par"] = per_cycle["rare_tjunction_par"] = 1.0
    # the rk4-tracers cell of phase 9d: one RK4 stream and one rare launch a cycle
    for name in rk4_launches:
        per_cycle[name] = rk4_launches[name] / sizes["rk4"]
    # phase 12: per sub-step of the whole run, all shards (S each on the DP
    # path, two remote rare calls a shard on the partitioned one)
    for name, v in list(dp_launches.items()) + [("rare_remote", part_launches["rare_remote"])]:
        per_cycle[name] = v / steps
    per_cycle["rare_pk_remote"] = part_launches["rare_pk_remote"] / sizes["slice"][2]
    for a, b in (("stream_philox", "stream"), ("convex_stream_xi", "convex_stream"),
                 ("macro_philox", "macro"), ("stream_pk_philox", "stream_pk")):
        per_cycle[a] = per_cycle[b]
    # each pass of a compacted cycle runs once per cycle on its path, each
    # pass of a compacted macro trip once per macro cycle
    for name in counts:
        if name.startswith(("stream_", "convex_stream_")) and name.endswith(("_crossers",
                                                                             "_admitted")):
            per_cycle[name] = 1.0
        elif name.startswith(("macro_crossers_t", "macro_admitted_t")):
            per_cycle[name] = (m_launches["macro_stream"] - m_launches["macro_crossers"]) / steps
    floor, host_floor = launch_floor_ms(torch, fused_cuda, Timer(torch, dev), dev)
    log(f"[bound] {gpu_line} | launch_floor_ms={floor:.5f} host_launch_ms={host_floor:.5f}: "
        f"hop_admit_kernel on 4 lanes, {BATCH} launches replayed from a graph, and enqueued "
        f"through the wrapper back to back")
    bounds = phase_bounds(torch, traffic, dev, counts, times, per_cycle, floor, gpu_line)
    latency = phase_latency(torch, traffic, probe, fused, fused_cuda, dev, slice_setup[0].tet_row,
                            rares, times, floor, gpu_line)
    if args.parent:
        phase_parent(traffic, rares, latency, gpu_line)

    def entry(name, key, source, replaces, n_launches, err, path="north-star slice", **extra):
        return {"name": name, "path": path, "phases": ERR_PHASES[key], "route": "cuda",
                "source": f"cudaparticlesfoam_tpu_torch/csrc/{source}",
                "replaces": f"cudaparticlesfoam_tpu/ops/{replaces}",
                "launches": n_launches, "max_abs_err": err, "ms": times[key][0],
                "plain_ms": times[key][1], "library_ms": None, **bounds[key],
                **latency.get(key, {}), **extra}

    table = {"kernels": [
        entry("stream_kernel", "stream", "stream.cu", "fused_pallas.py:334", launches["stream"],
              errs["stream"]),
        entry("rare_kernel", "rare", "rare.cu", "fused.py:921", launches["rare"], errs["rare"]),
        entry("convex_stream_kernel", "convex_stream", "convex_stream.cu",
              "fused_pallas.py:1910", launches["convex_stream"], errs["convex_stream"],
              path="north-star slice, convex"),
        entry("convex_rare_kernel", "convex_rare", "convex_rare.cu", "fused_convex.py:327",
              launches["convex_rare"], errs["convex_rare"], path="north-star slice, convex"),
        entry("hop_admit_kernel", "hop_admit", "hop_admit.cu", "fused_pallas.py:539",
              m_launches["hop_admit"], errs["hop_admit"], path="north-star slice, macro_cycles=4"),
        entry("macro_stream_kernel", "macro", "macro.cu", "fused_pallas.py:1536",
              m_launches["macro_stream"], errs["macro"], path="north-star slice, macro_cycles=4"),
        # the VertexVelocity instantiations (the TPU kernels under ly=LAYOUT_PK)
        entry("stream_kernel<pk>", "stream_pk", "stream.cu", "fused_pallas.py:259",
              pk_launches["stream_pk"], errs["stream_pk"],
              path="north-star slice, VertexVelocity", philox_ms=times["stream_pk_philox"][0]),
        entry("rare_kernel<pk>", "rare_pk", "rare.cu", "fused.py:836", pk_launches["rare_pk"],
              errs["rare_pk"], path="north-star slice, VertexVelocity"),
        # this slice's main path: the uncoupled driver on the pitzDaily tutorial
        # (launches from the CLI run of phase 8b, times and errors from 8c)
        entry("stream_kernel", "stream_tutorial", "stream.cu", "fused_pallas.py:319",
              tut_launches.get("stream_cycle", 0), errs["stream_tutorial"],
              path=TUTORIAL_PATH),
        entry("rare_kernel", "rare_tutorial", "rare.cu", "fused.py:921",
              tut_launches.get("rare_resolve", 0), errs["rare_tutorial"], path=TUTORIAL_PATH),
        # the RK4 instantiations (the XLA stage velocity of the jnp engine) on
        # the rk4-tracers cell, and the rare kernel on that path
        entry("stream_kernel<rk4>", "stream_rk4", "stream.cu", "fused.py:515",
              rk4_launches["stream_rk4"], errs["stream_rk4"], path=RK4_PATH),
        entry("rare_kernel", "rare_rk4", "rare.cu", "fused.py:921", rk4_launches["rare_rk4"],
              errs["rare_rk4"], path=RK4_PATH),
        entry("stream_kernel<pk, rk4>", "stream_pk_rk4", "stream.cu", "fused.py:515",
              rk4_launches["stream_pk_rk4"], errs["stream_pk_rk4"],
              path=RK4_PATH + ", VertexVelocity"),
        entry("rare_kernel<pk>", "rare_pk_rk4", "rare.cu", "fused.py:836",
              rk4_launches["rare_pk_rk4"], errs["rare_pk_rk4"],
              path=RK4_PATH + ", VertexVelocity"),
        # phase 11c: the coupled driver on the TJunction (launches from the CLI
        # run, times and errors from the cycle after step 1)
        entry("stream_kernel", "stream_tjunction", "stream.cu", "fused_pallas.py:319",
              tj_launches.get("stream_cycle", 0), errs["stream_tjunction"], path=TJUNC_PATH),
        entry("rare_kernel", "rare_tjunction", "rare.cu", "fused.py:921",
              tj_launches.get("rare_resolve", 0), errs["rare_tjunction"], path=TJUNC_PATH),
        # phase 12: data parallelism (each shard's kernels), and the partitioned
        # shard's rare stage (the XLA rare stage with _make_run_lanes_remote)
        entry("stream_kernel", "stream_dp", "stream.cu", "fused_pallas.py:319",
              dp_launches["stream_dp"], errs["stream_dp"], path=DP_PATH),
        entry("rare_kernel", "rare_dp", "rare.cu", "fused.py:921", dp_launches["rare_dp"],
              errs["rare_dp"], path=DP_PATH),
        entry("rare_kernel<remote>", "rare_remote", "rare.cu", "fused.py:393",
              part_launches["rare_remote"], errs["rare_remote"], path=PART_PATH),
        entry("rare_kernel<pk, remote>", "rare_pk_remote", "rare.cu", "fused.py:393",
              part_launches["rare_pk_remote"], errs["rare_pk_remote"],
              path=PART_PATH + ", VertexVelocity"),
        # phase 13: the coupled driver with the flow on 4 shards (launches from
        # the CLI run of 13b, times and errors from 13c's cycle after step 1)
        entry("stream_kernel", "stream_tjunction_par", "stream.cu", "fused_pallas.py:319",
              tjp_launches.get("stream_cycle", 0), errs["stream_tjunction_par"], path=TJP_PATH),
        entry("rare_kernel", "rare_tjunction_par", "rare.cu", "fused.py:921",
              tjp_launches.get("rare_resolve", 0), errs["rare_tjunction_par"], path=TJP_PATH),
    ]}
    # phase 14: the pressure solve's kernels on the pitzDaily Allrun's simple
    # (launches from 10b's CLI run) and the TJunction's coupled run (11c's);
    # times and bounds at each path's shapes (14a), errors from every 14a check
    # and each flow row's latency bound: the launch floor, its chain of
    # dependent loads (phase 6's neighbour-walk latency) and, for the tail,
    # its cluster barriers and the shared-memory reads that wait on the
    # phase before (traffic.amg_tail_chain; 14a's units)
    t_dep = latency["rare"]["t_dep_nbr_ms"]
    for launches, path, tm in ((pitz_launches, AMG_PITZ_PATH, amg_times["pitz"]),
                               (tj_launches, TJUNC_PATH, amg_times["tj"])):
        if dev.type == "cuda":
            need(all(launches.get(k, 0) > 0 for k in AMG_LAUNCH_KEYS),
                 f"a pressure-solve kernel or the CG graph never ran on {path!r}: {launches}")
        for k in AMG_KERNELS:
            row = tm[k]
            lat = traffic.amg_latency_bound(
                floor, (row["chain"], t_dep), (row["tail_barriers"], row["barrier_ms"]),
                (row["dsmem_loads"], row["t_dsmem_ms"]), (row["smem_loads"], row["t_smem_ms"]))
            row.update(launch_floor_ms=floor, t_dep_ms=t_dep, latency_bound_ms=lat,
                       share_of_latency=lat / row["ms"])
            log(f"[amg-bound] {gpu_line} | {path.split(' (')[0]}, {k}_kernel: latency bound "
                f"{lat:.5f} ms = launch floor {floor:.5f} + chain {row['chain']} x t_dep "
                f"{t_dep:.3e} + barriers {row['tail_barriers']} x {row['barrier_ms']:.5f} + "
                f"distributed shared memory reads {row['dsmem_loads']} x "
                f"{row['t_dsmem_ms']:.3e} + shared memory reads {row['smem_loads']} x "
                f"{row['t_smem_ms']:.3e}; ms={row['ms']:.5f} share_of_latency="
                f"{lat / row['ms']:.3f}; byte bound {row['bound_ms']:.5f} "
                f"(share {row['share']:.3f})")
            if "design_barriers" in row:
                # the tail plan's own floor beside the earlier design's bound (the yardstick)
                own = traffic.amg_latency_bound(
                    floor, (row["design_chain"], t_dep),
                    (row["design_barriers"], row["one_release_barrier_ms"]),
                    (row["design_dsmem_loads"], row["t_dsmem_ms"]),
                    (row["design_smem_loads"], row["t_smem_ms"]))
                row.update(design_floor_ms=own, share_of_design_floor=own / row["ms"])
                log(f"[amg-bound] {gpu_line} | {path.split(' (')[0]}, {k}_kernel: this "
                    f"design's floor {own:.5f} ms = launch floor + chain {row['design_chain']} "
                    f"x t_dep + barriers {row['design_barriers']} x "
                    f"{row['one_release_barrier_ms']:.5f} (warp 0 releases) + "
                    f"distributed shared memory reads {row['design_dsmem_loads']} + shared "
                    f"memory reads {row['design_smem_loads']}; share {own / row['ms']:.3f}"
                    + (f"; the parent's tail {row['parent_ms']:.5f} ms (share of the "
                       f"yardstick {lat / row['parent_ms']:.3f})" if "parent_ms" in row else ""))
            table["kernels"].append({
                "name": f"{k}_kernel", "path": path, "phases": ERR_PHASES[k], "route": "cuda",
                "source": "cudaparticlesfoam_tpu_torch/csrc/amg.cu", "replaces": AMG_REPLACES[k],
                "launches": launches.get(k, 0), "max_abs_err": errs[k], **row})
    # the per-call pack and unpack of run_cycles (launches from phase 5's three
    # calls, times and bounds from 5e at the same slice; bit for bit there)
    for k, line in (("pack", 108), ("unpack", 122)):
        table["kernels"].append({
            "name": f"{k}_kernel", "path": "north-star slice", "phases": "5, 5b, 5d, 5e",
            "route": "cuda", "source": "cudaparticlesfoam_tpu_torch/csrc/pack.cu",
            "replaces": f"cudaparticlesfoam_tpu/ops/fused.py:{line} ({k}_state, XLA ops)",
            "launches_per_cycle": pack_table[k]["launches"] / steps, "max_abs_err": 0.0,
            "library_ms": None, **pack_table[k]})
    log(gpu_line)
    log(json.dumps(table))
    if args.rehearse:
        log("rehearsal done: plain versions on the CPU, no device result")
        return 2
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
