#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cudaparticlesfoam_tpu_torch) on one GPU.

    python3 chip_smoke.py               # the full check on cuda:0
    python3 chip_smoke.py --rehearse    # small sizes on the CPU, plain versions only
    python3 chip_smoke.py --parent DIR  # also phase 7, against the checkout in DIR

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
   device's time without the host's launch gap; a measuring device, the
   port launches no graph; the trips' passes are timed the same way).
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
        the tutorial: blockmesh, dict deltaT 1.0, simple (500 iterations,
        stopped by residualControl), dict deltaT 0.1, uncoupled at the
        tutorial's settings; simple's field finite, max |U| < 50, written
        inside [282, 382], U, p and phi read back, the streamline file
        parses; then phase 8b's frame checks, the mean x moved downstream,
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


def rare_patterns(torch, counter, kernel, plain, m, real, tag):
    """The rare kernel ``kernel(m, pend)`` against ``plain(m, pend)`` on
    every pattern of PATTERNS: the whole mega identical bit for bit, one
    launch a call.  Returns the launches made."""
    for name in PATTERNS:
        pend = pend_pattern(torch, name, real)
        mk, mp = m.clone(), m.clone()
        before = counter.launches
        kernel(mk, pend)
        launched = counter.launches - before
        plain(mp, pend)
        need(bitwise_equal(torch, mk, mp), f"{tag} pending={name}: kernel != plain")
        if m.device.type == "cuda":
            need(launched == 1, f"{tag} pending={name}: {launched} launches for one call")
    return len(PATTERNS)


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
        m0 = fused.pack_state(mesh, pos[:nn], vel[:nn], tet[:nn], act[:nn])
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
        m = fused.pack_state(mesh, pos[:nn].double(), vel[:nn].double(), tet[:nn], act[:nn])
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
                m0 = fused.pack_state(mesh, pos[:nn], vel[:nn], tet[:nn], act[:nn], ly)
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
        m0 = fused_convex.pack_state(mesh, tab, pos, vel, tet, act)
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
        m = fused_convex.pack_state(mesh, tab, pos[:nn].double(), vel[:nn].double(), tet[:nn],
                                    act[:nn])
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
    m0 = fused.pack_state(mesh, pos, vel, tet, act)
    mk = fused.mega_cycle(mesh, m0.clone(), seed, step, cfg, cfg.dt)
    mp, pp = m0.clone(), torch.empty(n, dtype=torch.uint8, device=dev)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **stream_args(cfg, cfg.dt, mp.dtype, fused))
    fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **rare_args(cfg))
    same_b, err_b = compare(torch, mk, mp)
    # convex, the same way
    ccfg = dataclasses.replace(cfg, locate_mode="convex")
    tab = fused_convex.cx_table(mesh)
    c0 = fused_convex.pack_state(mesh, tab, pos, vel, tet, act)
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
    cm = fused_convex.pack_state(mesh, tab, p, torch.zeros_like(p), t, on)
    pend = torch.empty(n_stats, dtype=torch.uint8, device=dev)
    disp = torch.empty((n_stats, 3), dtype=torch.float32, device=dev)
    fused_cuda.convex_stream_cycle(tab, cm, None, pend, disp, dt=dt_t, sigma=sigma,
                                   use_adv=False, use_brown=True, n_hops=0,
                                   noise_key=fused.philox_key(7, 3))
    bm = fused.pack_state(mesh, p, torch.zeros_like(p), t, on)
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
    stream)`` of the kernel's entry ``entry`` in any build of the library."""
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
            if self.parent else None)


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
    fused_cuda.stream_cycle.launches = 0
    fused_cuda.rare_resolve.launches = 0
    runs = []
    for _ in range(3):
        timer.start()
        st = cpt.run_cycles(mesh, st, cfg, n_cycles)
        runs.append(timer.stop())
    launches = {"stream": fused_cuda.stream_cycle.launches,
                "rare": fused_cuda.rare_resolve.launches}
    ms_cycle = [r / n_cycles for r in runs]
    med = float(np.median(ms_cycle))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[slice] {gpu_line} | ms_per_cycle={['%.4f' % x for x in ms_cycle]} "
        f"median={med:.4f} particle_steps_per_s={n_particles / (med * 1e-3):.4e} "
        f"max_memory_allocated={peak} launches={launches}")
    if dev.type == "cuda":
        need(launches == {"stream": 3 * n_cycles, "rare": 3 * n_cycles},
             f"launch counts {launches} != {3 * n_cycles} per kernel")

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
    m0 = fused.pack_state(mesh, st.pos, st.vel, st.tet_id, st.active)
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
    m0 = fused_convex.pack_state(mesh, tab, st.pos, st.vel, st.tet_id, st.active)
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

    # one extra cycle through kernel and plain on the same inputs
    m0 = fused.pack_state(mesh, st.pos, st.vel, st.tet_id, st.active, ly)
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
                m0 = fused_convex.pack_state(mesh, tab, pos, vel, tet, act)
                cycle = fused_convex.mega_cycle
                args = (mesh, tab)
            else:
                tab = mesh.tet_row
                m0 = fused.pack_state(mesh, pos, vel, tet, act)
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
            m0 = fused.pack_state(mesh, pos[:nn], vel[:nn], tet[:nn], act[:nn])
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
           "macro_crossers")


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
    of reps x restore is subtracted.  A measuring device only: the port
    launches no graph.  On the CPU (rehearsal) the same loops on the host
    clock."""
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
                                  "hop_admit": (k - 1) * macs, "rare_resolve": k * macs},
                  "macro slice")
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
    m0 = fused.pack_state(mesh, st.pos, st.vel, st.tet_id, st.active)
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
                             f"{pre}stream_cycle": n_cycles,
                             f"{pre}rare_resolve": n_cycles}, tag)
    domain_check(torch, cpt, cmesh, st_c, n_in, tag)

    # one more cycle's stages, and the compacted stream's time against plain
    if convex:
        tab = fused_convex.cx_table(cmesh)
        m0 = fused_convex.pack_state(cmesh, tab, st_c.pos, st_c.vel, st_c.tet_id,
                                     st_c.active)
    else:
        tab = cmesh.tet_row
        m0 = fused.pack_state(cmesh, st_c.pos, st_c.vel, st_c.tet_id, st_c.active)
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
         "rare_pk_rk4")


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
    the slice phases, each share of the latency bound of phase 6."""
    for name, r in rares.rows.items():
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
    need_launches(dev, got, {"stream_cycle": 100, "rare_resolve": 100}, "driver anchor")


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
    m0 = fused.pack_state(mesh, st.pos, st.vel, st.tet_id, st.active)
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
                m0 = fused.pack_state(mesh, pos[:nn], vel[:nn], tet[:nn], act[:nn], ly)
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
        need_launches(dev, got, {"stream_cycle": n_cycles, "rare_resolve": n_cycles},
                      f"rk4 slice ({vi})")
        if dev.type == "cuda":
            need(launches[skey] == n_cycles, f"rk4 slice ran {launches[skey]} RK4 launches")
        domain_check(torch, cpt, mesh, st, n_in, "rk4-slice")

        # one more cycle through kernel and plain, with the plain's stage walks
        m0 = fused.pack_state(mesh, st.pos, st.vel, st.tet_id, st.active, ly)
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
)


def register_report(_build, lines):
    """Phase 9e: ptxas's registers, stack and spills of each RK4
    instantiation of stream_kernel, and every other kernel's line against
    PINNED_PTXAS (compared where this build's nvcc is the pinned one)."""
    rk4 = [line for line in lines if "rk4" in line.split(":")[0]]
    rest = sorted(line for line in lines if line not in rk4)
    for line in rk4:
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
    log(f"[registers] rk4_instantiations={len(rk4)} other_kernels={len(rest)} "
        f"unchanged_against_pinned={int(not changed)} (nvcc {PINNED_NVCC})")
    need(len(rk4) == 8 and not changed,
         f"ptxas lines differ from the pinned ones: {changed}, or not 8 RK4 lines: {rk4}")


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
            if targs.startswith("ILi"):
                name = f"{base}<{re.match(r'ILi(-?\d+)E', targs).group(1)}>"
            elif targs.startswith("I"):
                args = [{"d": "double", "f": "float"}[targs[1]]]
                flags = re.findall(r"L[bi](\d+)E", targs.split("EE", 1)[0] + "E")
                if flags and flags[0] == "1":
                    args.append("philox")
                if len(flags) > 1 and flags[1] != "0":
                    args.append(("", "crossers", "admitted")[int(flags[1])])
                if "8LayoutPk" in targs.split("EE", 1)[0]:
                    args.append("pk")
                if len(flags) > 2 and flags[2] == "1":
                    args.append("rk4")
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
SIMPLE_ITERS_CAP = None   # --iters of 10b's simple; None: the tutorial's 500 and residualControl
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
    repo's pitzDaily: blockmesh, dict deltaT 1.0, simple (500 iterations,
    stopped by residualControl), dict deltaT 0.1, uncoupled at the
    tutorial's settings; the rehearsal runs simple --iters 5 on the CPU and
    the tracker at 2,000 particles, deltaT 0.01.  ``shear``: phase 8b's
    numbers, for Advect on the shear field beside the solved one.  Returns
    (case dir, written time)."""
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
    return case, t_write


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
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    calls = [e for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                             "cuLaunchKernel", "cuLaunchKernelEx")]
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
            "kernels": kernels, "launch_calls": calls, "busy_ms": busy}


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at small sizes on the CPU (plain versions "
                         "only); prints no device result and exits 2")
    ap.add_argument("--parent", metavar="DIR",
                    help="also build the rare kernels of the checkout in DIR (another commit) "
                         "and time them against this tree's on the same inputs (phase 7)")
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
                     rk4_parity=1024, flow_warm=1)
        gpu_line = "cpu rehearsal"
        kind = "cpu"
    else:
        if not torch.cuda.is_available():
            print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        sizes = dict(parity=(16, 65_536), stats=1_000_000, slice=(55, 1_000_000, 200), simple=5,
                     admit=(1, 3, 4, 15, 16, 17, 65_499, 65_536, 1_000_000, 4_000_001),
                     driver_warm=100, rk4=100, rk4_parity=65_536, flow_warm=5)
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
        flow_case, t_write = phase_flow_tutorial(torch, dev, os.path.join(tmp, "allrun"),
                                                 args.rehearse, gpu_line, tut)
        phase_flow_split(torch, dev, flow_case, t_write, gpu_line, sizes["flow_warm"])

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
    # the rk4-tracers cell of phase 9d: one RK4 stream and one rare launch a cycle
    for name in rk4_launches:
        per_cycle[name] = rk4_launches[name] / sizes["rk4"]
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
        return {"name": name, "path": path, "route": "cuda",
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
    ]}
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
