"""Frozen-field particle tracking through ``run_cycles``, one call a chunk of
``cycles_per_call`` sub-steps, as the uncoupled driver calls it between
frames (the frames themselves are not written).

Set-up: the configuration's builder makes the mesh, the field and the start
positions from the seed; the program builds its mesh, locates the seeds,
tunes the step as its drivers do, and runs one call, which builds and loads
the kernels and is the check's start.  The window then chains calls until
``--seconds`` have passed and ends in a synchronize.

The check (after the window, the program's mesh freed): the reference
builds its own tables and locates the start positions itself, then

* chains the start call and the window's first ``chained_calls`` calls
  from its own state, which nothing of the program's went into;
* runs the calls of the window that follow ``checked_calls`` moments drawn
  from the seed, and the window's last call, each from the program's state
  before it;

and every lane's tet, active flag and position is compared with what the
program returned.  The reference splits each sub-step's walk between its
stream and rare stages at the configuration's ``inline_hops``, whatever
the program's tuning; on the last call it also counts the table rows the
stream stage loads, from which the roofline's bytes are reckoned.
"""

from __future__ import annotations

import statistics
import time
import types

import numpy as np
import torch

from harness import spec
from harness.run import Outcome, log, memory_peak, sync

from reference import particles as ref

ISSUE_CALLS = 5      # synchronised calls whose host issue time the traced run reads




class ControlRun:
    """The reference in the program's place, its float columns in bfloat16."""

    def __init__(self, inp, config):
        self.tab, self.bd = ref.build_table(inp.points, inp.tets, inp.tet_vel,
                                            inp.pos.dtype, inp.pos.device)
        self.tab = ref.round_table_bf16(self.tab)
        self.config = config
        self.seed = None

    def run_cycles(self, st, n_cycles):
        pos, vel, tet, act = ref.run(
            self.tab, self.bd, st.pos, st.vel, st.tet_id, st.active, seed=self.seed,
            step=st.step, n_cycles=n_cycles, dt=self.config["dt"],
            diffusion_coeff=self.config["diffusion_coeff"],
            n_hops=self.config["inline_hops"], bounce_on=True, rounding=ref.round_mega_bf16)
        return types.SimpleNamespace(pos=pos, vel=vel, tet_id=tet, active=act,
                                     step=st.step + n_cycles)


def _state(pos, tet, seed):
    n = pos.shape[0]
    return types.SimpleNamespace(pos=pos, vel=torch.zeros_like(pos), tet_id=tet,
                                 active=torch.ones(n, dtype=torch.bool, device=pos.device),
                                 step=0, seed=seed)


def run(ctx) -> Outcome:
    cfgd, dev = ctx.config, ctx.device
    K = int(ctx.traffic["cycles_per_call"])
    builder = spec.load_module("builders", cfgd["builder"])
    inp = builder.build(cfgd, ctx.seed, dev)
    n = inp.pos.shape[0]

    if ctx.variant == "control":
        prog = ControlRun(inp, cfgd)
        prog.seed = ctx.seed
        st0 = _state(inp.pos, ref.locate(prog.tab, inp.points, inp.tets, inp.pos), ctx.seed)

        def advance(st):
            return prog.run_cycles(st, K)

        counters = None
        tuned = None
    else:
        cpt = ctx.program()
        from cudaparticlesfoam_tpu_torch.ops import fused_cuda

        mesh = cpt.from_arrays(inp.points, inp.tets, tet_vel=inp.tet_vel, dtype=inp.pos.dtype,
                               device=dev)
        loc = cpt.build_grid_locator(mesh)
        tet0 = cpt.locate_seeds(mesh, loc, inp.pos)
        st0 = cpt.make_state(inp.pos, tet_id=tet0, rng_seed=ctx.seed, device=dev)
        tuned = cpt.suggest_tuning(
            mesh, cpt.StepConfig(dt=cfgd["dt"], diffusion_coeff=cfgd["diffusion_coeff"],
                                 brownian_rng=cfgd["brownian_rng"],
                                 locate_mode=cfgd["locate_mode"],
                                 integrator=cfgd["integrator"]), cfgd["dt"], n_particles=n)

        def advance(st):
            return cpt.run_cycles(mesh, st, tuned, K)

        def counters():
            return {"stream_cycle": fused_cuda.stream_cycle.launches,
                    "rare_resolve": fused_cuda.rare_resolve.launches}

    # the start: one call, which builds and loads every kernel the window runs
    st1 = advance(st0)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    log(f"set-up: {setup_s:.3f} s ({n} particles, {K} cycles a call"
        + (f", inline_hops={tuned.inline_hops} inline_bounce={tuned.inline_bounce})"
           if tuned else ")"))

    tracer = ctx.tracer
    tracer.warm_up()
    # the calls the check follows: the first issued after each of these
    # moments of the window, drawn from the seed, and the last
    rng = np.random.default_rng(int(ctx.seed) % (1 << 63))
    due = sorted(rng.uniform(0.0, ctx.seconds, int(ctx.traffic["checked_calls"])))
    chained = [st1]       # the start call's and the window's first calls' results
    n_chained = 1 + int(ctx.traffic["chained_calls"])
    kept = []
    launches0 = counters() if counters else None
    calls, prev, cur = 0, st1, st1
    with tracer.window():
        t_start = time.perf_counter()
        while True:
            now, keep = time.perf_counter() - t_start, False
            while due and now >= due[0]:
                due.pop(0)
                keep = True
            with tracer.span("run_cycles"):
                out = advance(cur)
            if keep:
                kept.append((f"call {calls}", cur, out))
            if len(chained) < n_chained:
                chained.append(out)
            prev, cur = cur, out
            calls += 1
            if time.perf_counter() - t_start >= ctx.seconds:
                break
        with tracer.span("synchronize"):
            sync(dev)
        window_s = time.perf_counter() - t_start
    if not kept or kept[-1][2] is not cur:
        kept.append((f"call {calls - 1}", prev, cur))
    kept[-1] = (kept[-1][0] + " (last)", kept[-1][1], kept[-1][2])
    peak = memory_peak(dev)
    data = {"cycles": calls * K, "lanes": n, "cycles_per_call": K,
            "elem": inp.pos.element_size()}
    if counters:
        launches1 = counters()
        log("wrapper launches a sub-step: " + ", ".join(
            f"{k} {(launches1[k] - launches0[k]) / (calls * K):.4f}" for k in launches1))
    summary = tracer.summary() if ctx.trace else None

    if ctx.trace and ctx.variant == "program":
        # the host's issue time a cycle, each call issued onto an idle device
        issue = []
        for _ in range(ISSUE_CALLS):
            sync(dev)
            h0 = time.perf_counter()
            cur = advance(cur)
            issue.append((time.perf_counter() - h0) * 1e3 / K)
        sync(dev)
        data["host_issue_ms_per_cycle"] = statistics.median(issue)
    del cur, prev, out
    if ctx.variant == "program":
        del mesh, loc, advance
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    failed = _check(ctx, inp, chained, kept, K, data)
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    e2e = {"particle_steps_per_s": n * calls * K / window_s, "setup_s": setup_s}
    log(f"window: {calls} calls of {K} cycles in {window_s:.4f} s; "
        f"{e2e['particle_steps_per_s']:.6e} particle-steps/s")
    return Outcome(end_to_end=e2e, attempted=calls, failed=failed, memory_peak_bytes=peak,
                   data=data, trace=summary)


def _check(ctx, inp, chained, kept, K, data) -> int:
    """Compare every lane of the chained and the kept calls with the
    reference; returns the number of calls that differ."""
    cfgd, dev = ctx.config, ctx.device
    limits = cfgd["limits"]
    tab, bd = ref.build_table(inp.points, inp.tets, inp.tet_vel, inp.pos.dtype, dev)
    counts = {"rows_loaded": 0, "rows_changed": 0}
    lanes_off, pos_err, failed = 0, 0.0, 0

    def follow(label, sin, sout, count=False):
        nonlocal lanes_off, pos_err, failed
        pos, vel, tet, act = ref.run(
            tab, bd, sin.pos, sin.vel, sin.tet_id, sin.active, seed=ctx.seed, step=sin.step,
            n_cycles=K, dt=cfgd["dt"], diffusion_coeff=cfgd["diffusion_coeff"],
            n_hops=cfgd["inline_hops"], bounce_on=True, counts=counts if count else None)
        off = int(((tet != sout.tet_id) | (act != sout.active)).sum())
        err = float((pos - sout.pos).abs().max())
        log(f"check {label}: steps {sin.step}..{sin.step + K - 1}, lanes off the reference "
            f"{off}, largest position error {err!r}")
        lanes_off += off
        pos_err = max(pos_err, err)
        failed += int(off > limits["lanes_off_reference"]
                      or not err <= limits["position_error_max"])
        return types.SimpleNamespace(pos=pos, vel=vel, tet_id=tet, active=act,
                                     step=sin.step + K)

    # the reference's own chain from the benchmark's positions
    st = _state(inp.pos, ref.locate(tab, inp.points, inp.tets, inp.pos), ctx.seed)
    for i, out in enumerate(chained):
        st = follow("start" if i == 0 else f"chained call {i - 1}", st, out)
    # calls of the window from the program's state before each
    for label, sin, sout in kept:
        follow(label, sin, sout, count=label.endswith("(last)"))
    data["stream_rows_loaded_per_cycle"] = counts["rows_loaded"] / K
    data["stream_rows_changed_per_cycle"] = counts["rows_changed"] / K
    ctx.checks.add("lanes_off_reference", lanes_off, limits["lanes_off_reference"])
    ctx.checks.add("position_error_max", pos_err, limits["position_error_max"])
    return failed
