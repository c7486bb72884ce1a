"""Coupled Eulerian steps of a case through ``coupled.CoupledRun``: each step
the PIMPLE flow step, the function objects (probes, scalarTransport), the
refresh of the particles' tet table from the new U, and the interval's
sub-steps in ``run_cycles`` calls on the case's saveInterval schedule (the
frames themselves are not written).

Set-up: the configuration's builder copies the case with the particles'
window opened at the first step and draws the start positions from the
seed; the program builds its case (mesh, tet mesh, tables), its flow solver
and its particles, with the seed as their noise seed, runs
``warmup_steps`` steps from the initial fields (the first captures every
solve and loads every kernel the window runs) and keeps that state, S
(``CoupledRun.snapshot``).

Window: segments of ``segment_steps`` steps, each started from S
(``CoupledRun.restore``), so that every run does the same work a step,
however fast the program is; the window closes at the end of the segment in
which ``--seconds`` have passed, with a synchronize.  ``flow_step_ms`` is
the window over its steps: the wall time of a coupled Eulerian step.

Check (after the window, the program freed): the reference
(:mod:`reference.coupled`) builds its own mesh, tets and tables from the
same blockMeshDict, locates the same start positions and runs the warm-up
steps and one segment from the initial fields.  S is compared with the
reference's state after the warm-up, and the end of a segment of the
window drawn from the seed, and of the last, with the reference's after
the segment: U, p, phi, k, epsilon and s, and every probe sample, each as
its largest difference over the reference's largest magnitude; every
lane's tet and active flag; every lane's position; and the CG iterations
of every pressure solve of the warm-up and the segments.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness import spec
from harness.run import Outcome, log, memory_peak, sync

from reference import coupled as refc

FIELDS = ("U", "p", "phi", "k", "epsilon", "s")


class Program:
    """The program's run: ``coupled.CoupledRun`` on the card."""

    def __init__(self, ctx, case_dir, pos):
        ctx.program()
        from cudaparticlesfoam_tpu_torch.models import coupled

        self.run = coupled.CoupledRun(case_dir, write_output=False, log=lambda *a: None,
                                      device=ctx.device, rng_seed=ctx.seed, positions=pos)

    def step(self) -> list:
        return list(self.run.step()["cg_iterations"])

    def snapshot(self):
        return self.run.snapshot()

    def restore(self, snap) -> None:
        self.run.restore(snap)

    def outputs(self) -> dict:
        r = self.run
        f = r.flow
        out = {"U": f.state.u, "p": f.state.p, "phi": f.state.flux, "k": f.kes.k,
               "epsilon": f.kes.eps, "s": r.scalar.s, "pos": r.state.pos,
               "tet": r.state.tet_id, "active": r.state.active}
        return {k: v.clone() for k, v in out.items()}

    def probe_samples(self, last: int) -> list:
        """The last ``last`` samples, as (t, p, U)."""
        s = self.run.probes.samples
        return [(tp, torch.as_tensor(p), torch.as_tensor(u))
                for (tp, p), (_, u) in zip(s["p"][-last:], s["U"][-last:])]

    def describe(self) -> str:
        r = self.run
        return (f"{r.init['n_cells']} cells, {r.init['n_tets']} tets, {r.init['n_particles']} "
                f"particles, host builder {r.init['builder']}, inline_hops "
                f"{r.cfg.inline_hops} inline_bounce={r.cfg.inline_bounce}")


class Control:
    """The reference in the program's place, in bfloat16 (the control)."""

    def __init__(self, ctx, case_dir, pos):
        self.ref = refc.CoupledReference(case_dir, pos, ctx.seed, ctx.config["inline_hops"],
                                         ctx.device, lower_precision=True)

    def step(self) -> list:
        return self.ref.step()

    def snapshot(self):
        r = self.ref
        return {"flow": (r.flow.state, r.flow.kes, r.flow.time, r.flow.p_bcs),
                "s": r.scalar.s, "n_samples": len(r.probes.samples), "tab": r.tab.clone(),
                "lanes": (r.pos, r.vel, r.tet, r.active), "clock": (r.t, r.sub_step)}

    def restore(self, snap) -> None:
        r = self.ref
        r.flow.state, r.flow.kes, r.flow.time, r.flow.p_bcs = snap["flow"]
        r.scalar.s, r.tab = snap["s"], snap["tab"].clone()
        del r.probes.samples[snap["n_samples"]:]
        r.pos, r.vel, r.tet, r.active = snap["lanes"]
        r.t, r.sub_step = snap["clock"]

    def outputs(self) -> dict:
        return {k: v.clone() for k, v in self.ref.outputs().items()}

    def probe_samples(self, last: int) -> list:
        return reference_samples(self.ref, last)

    def describe(self) -> str:
        return "the reference in bfloat16"


def reference_samples(ref, last: int) -> list:
    return [(t, p, u) for t, p, u in ref.probes.samples[-last:]]


def run(ctx) -> Outcome:
    cfgd, tr, dev = ctx.config, ctx.traffic, ctx.device
    W, K = int(tr["warmup_steps"]), int(tr["segment_steps"])
    builder = spec.load_module("builders", cfgd["builder"])
    case_dir = builder.prepare(cfgd)
    pos = builder.positions(cfgd, ctx.seed, dev)

    prog = (Control if ctx.variant == "control" else Program)(ctx, case_dir, pos)
    warm_iters = [prog.step() for _ in range(W)]
    start = prog.snapshot()
    start_out = (prog.outputs(), prog.probe_samples(W))
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    log(f"set-up: {setup_s:.3f} s ({prog.describe()}; {W} warm-up steps, CG iterations "
        f"{warm_iters})")

    rng = np.random.default_rng(int(ctx.seed) % (1 << 63))
    due = float(rng.uniform(0.0, ctx.seconds))
    tracer = ctx.tracer
    tracer.warm_up()
    kept = []
    steps = segments = 0
    with tracer.window():
        t_start = time.perf_counter()
        seg_ends = [t_start]
        while True:
            keep = due is not None and time.perf_counter() - t_start >= due
            with tracer.span("restore"):
                prog.restore(start)
            its = []
            for _ in range(K):
                with tracer.span("CoupledRun.step"):
                    its.append(prog.step())
            steps += K
            segments += 1
            seg_ends.append(time.perf_counter())
            last = time.perf_counter() - t_start >= ctx.seconds
            if keep or last:
                label = f"segment {segments - 1}" + (" (last)" if last else "")
                kept.append((label, its, prog.outputs(), prog.probe_samples(K)))
                due = None
            if last:
                break
        with tracer.span("synchronize"):
            sync(dev)
        window_s = time.perf_counter() - t_start
    peak = memory_peak(dev)
    summary = tracer.summary() if ctx.trace else None
    data = {"steps": steps}
    e2e = {"flow_step_ms": window_s * 1e3 / steps, "setup_s": setup_s}
    seg_ms = np.diff(seg_ends) * 1e3 / K
    log(f"host clock a step by segment (issued; the last also drains): min "
        f"{seg_ms.min():.3f} median {np.median(seg_ms):.3f} max {seg_ms.max():.3f} ms")
    log(f"window: {segments} segments of {K} steps in {window_s:.4f} s; "
        f"{e2e['flow_step_ms']:.4f} ms a step; CG iterations a segment {kept[-1][1]}")
    del prog, start
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    failed = _check(ctx, case_dir, pos, W, K, warm_iters, start_out, kept)
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    return Outcome(end_to_end=e2e, attempted=segments, failed=failed, memory_peak_bytes=peak,
                   data=data, trace=summary)


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b| (b the reference's)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    b = b.to(a.device)
    scale = float(b.abs().max()) if b.numel() else 0.0
    diff = float((a.to(b.dtype) - b).abs().max()) if b.numel() else 0.0
    err = diff / scale if scale > 0 else diff
    return err if math.isfinite(err) else math.inf


def compare(label, got, samples, ref, ref_samples) -> dict:
    """The compared numbers of one state against the reference's."""
    errs = {k: _rel(got[k], ref[k]) for k in FIELDS}
    if len(samples) != len(ref_samples):
        errs["probes"] = math.inf
    for i, ((ta, pa, ua), (tb, pb, ub)) in enumerate(zip(samples, ref_samples)):
        errs[f"probe_p[{i}]"] = _rel(pa, pb) if ta == tb else math.inf
        errs[f"probe_U[{i}]"] = _rel(ua, ub) if ta == tb else math.inf
    off = int(((got["tet"] != ref["tet"].to(got["tet"].dtype))
               | (got["active"] != ref["active"])).sum())
    pos_err = float((got["pos"] - ref["pos"]).abs().max())
    field = max(errs.values())
    log(f"check {label}: " + " ".join(f"{k}={v!r}" for k, v in errs.items() if "[" not in k)
        + f" probes={max([v for k, v in errs.items() if '[' in k] or [0.0])!r}"
        + f" lanes off the reference {off}, largest position error {pos_err!r}")
    return {"field": field, "off": off, "pos": pos_err}


def _check(ctx, case_dir, pos, W, K, warm_iters, start_out, kept) -> int:
    limits = ctx.config["limits"]
    t0 = time.perf_counter()
    ref = refc.CoupledReference(case_dir, pos, ctx.seed, ctx.config["inline_hops"], ctx.device)
    log(f"check: the reference's mesh, tets, table, flow and lanes in "
        f"{time.perf_counter() - t0:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in ref.setup_s.items()) + ")")
    ref_warm = [ref.step() for _ in range(W)]
    results = [compare(f"start (after {W} warm-up steps)", *start_out, ref.outputs(),
                       reference_samples(ref, W))]
    ref_seg = [ref.step() for _ in range(K)]
    ref_end, ref_end_samples = ref.outputs(), reference_samples(ref, K)
    for label, _, out, samples in kept:
        results.append(compare(label, out, samples, ref_end, ref_end_samples))
    failed = sum(int(not (r["field"] <= limits["field_rel_error_max"]
                          and r["off"] <= limits["lanes_off_reference"]
                          and r["pos"] <= limits["position_error_max"])) for r in results[1:])
    ours = warm_iters + [i for _, its, _, _ in kept for i in its]
    theirs = ref_warm + ref_seg * len(kept)
    cg_off = sum(int(a != b) for a, b in zip(ours, theirs)) + abs(len(ours) - len(theirs))
    log(f"check CG iterations: program {warm_iters} + {kept[-1][1]}, reference {ref_warm} + "
        f"{ref_seg}")
    ctx.checks.add("field_rel_error_max", max(r["field"] for r in results),
                   limits["field_rel_error_max"])
    ctx.checks.add("cg_iterations_off", cg_off, limits["cg_iterations_off"])
    ctx.checks.add("lanes_off_reference", sum(r["off"] for r in results),
                   limits["lanes_off_reference"])
    ctx.checks.add("position_error_max", max(r["pos"] for r in results),
                   limits["position_error_max"])
    return failed
