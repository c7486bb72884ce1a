"""Eulerian PIMPLE steps of a case's flow through ``FlowSolver.advance``, flow
only, at the adaptive time step (``maxCo``) of the case's controlDict.

Set-up: the program builds the mesh from the case's blockMeshDict, its FV
tables, AMG hierarchy and closure (``FlowSolver.from_case``), runs
``warmup_steps`` steps from the initial fields (the first step makes every
row plan and capture its solves need) and keeps that state, S.

Window: segments of ``segment_steps`` steps, each started from S, so that
every run does the same work a step, however fast the program is; the
window closes at the end of the segment in which ``--seconds`` have passed,
with a synchronize.

Check (after the window): the reference builds its own mesh from the same
blockMeshDict and runs the warm-up steps and one segment from the initial
fields; S is compared with the reference's state after the warm-up, and the
end of a segment of the window drawn from the seed, and of the last, with
the reference's after the segment: U, p, phi, k and epsilon, each as its
largest difference over the reference's largest magnitude, and the CG
iterations of every pressure solve of the warm-up and the segment.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import types

import numpy as np
import torch

from harness import spec
from harness.run import Outcome, log, memory_peak, sync

FIELDS = ("U", "p", "phi", "k", "epsilon")



def _control(case_dir, foamfile):
    d = foamfile.read(os.path.join(case_dir, "system", "controlDict"))
    adjust = str(d.get("adjustTimeStep", "no")) in ("yes", "true", "on", "1")
    return types.SimpleNamespace(delta_t=float(d.get("deltaT", 0.1)),
                                 max_co=float(d.get("maxCo", 1.0)), adjust_time_step=adjust)


def fields_of(flow) -> dict:
    """The compared fields of a solver (the program's or the reference's)."""
    out = {"U": flow.state.u, "p": flow.state.p, "phi": flow.state.flux}
    if flow.kes is not None:
        out["k"], out["epsilon"] = flow.kes.k, flow.kes.eps
    return out


class Stepper:
    """A flow solver with its control: ``step()`` takes one adaptive step and
    returns the CG iterations of its solves; ``save()`` / ``load()`` keep and
    restore the state (fields, closure, time, pressure table)."""

    def __init__(self, flow, ctrl, rounding=None):
        self.flow, self.ctrl, self.rounding = flow, ctrl, rounding

    def dt(self) -> float:
        f, c = self.flow, self.ctrl
        return f.stable_dt(c) if c.adjust_time_step else c.delta_t

    def step(self) -> list:
        return self.step_at(self.dt())

    def step_at(self, dt: float) -> list:
        f = self.flow
        res = f.advance(dt)
        if self.rounding is not None:
            f.state = dataclasses.replace(f.state, **{k: self.rounding(getattr(f.state, k))
                                                      for k in ("u", "p", "flux")})
            if f.kes is not None:
                f.kes = dataclasses.replace(f.kes, **{k: self.rounding(getattr(f.kes, k))
                                                      for k in ("k", "eps", "nut")})
        return list(res["p_iters"])

    def save(self) -> dict:
        f = self.flow
        return {"state": dataclasses.replace(f.state, **{k: getattr(f.state, k).clone()
                                                         for k in ("u", "p", "flux")}),
                "kes": None if f.kes is None else dataclasses.replace(
                    f.kes, **{k: getattr(f.kes, k).clone() for k in ("k", "eps", "nut")}),
                "time": f.time, "p_bcs": f.p_bcs}

    def load(self, s: dict) -> None:
        f = self.flow
        f.state = dataclasses.replace(s["state"], **{k: getattr(s["state"], k).clone()
                                                     for k in ("u", "p", "flux")})
        if s["kes"] is not None:
            f.kes = dataclasses.replace(s["kes"], **{k: getattr(s["kes"], k).clone()
                                                     for k in ("k", "eps", "nut")})
        f.time, f.p_bcs = s["time"], s["p_bcs"]


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def reference_stepper(case_dir, dtype, device, rounding=None) -> Stepper:
    """The reference's solver of the case, its own mesh from blockMeshDict."""
    from reference.flow import blockmesh, foamfile
    from reference.flow import pimple as rpimple

    pm = blockmesh.generate(os.path.join(case_dir, "system", "blockMeshDict"))
    flow = rpimple.FlowSolver(case_dir, pm, dtype, device)
    return Stepper(flow, _control(case_dir, foamfile), rounding)


def program_stepper(ctx, case_dir, dtype) -> Stepper:
    ctx.program()
    from cudaparticlesfoam_tpu_torch.config import ControlConfig
    from cudaparticlesfoam_tpu_torch.models import case as caselib
    from cudaparticlesfoam_tpu_torch.models import pimple

    quiet = lambda *a: None  # noqa: E731
    poly = caselib.load_polymesh(case_dir, log=quiet)
    case = types.SimpleNamespace(case_dir=case_dir, poly=poly, time_value=0.0, time_dir="0",
                                 tet_mesh=None)
    flow = pimple.FlowSolver.from_case(case, log=quiet, dtype=dtype, device=ctx.device)
    return Stepper(flow, ControlConfig.from_case(case_dir))


def run(ctx) -> Outcome:
    cfgd, tr, dev = ctx.config, ctx.traffic, ctx.device
    dtype = {"float32": torch.float32, "float64": torch.float64}[cfgd["flow_dtype"]]
    W, K = int(tr["warmup_steps"]), int(tr["segment_steps"])
    builder = spec.load_module("builders", cfgd["builder"])
    case_dir = builder.prepare(cfgd)

    if ctx.variant == "control":
        prog = reference_stepper(case_dir, dtype, dev, rounding=_bf16)
    else:
        prog = program_stepper(ctx, case_dir, dtype)
    warm_iters = [prog.step() for _ in range(W)]
    start = prog.save()
    start_fields = {k: v.clone() for k, v in fields_of(prog.flow).items()}
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    log(f"set-up: {setup_s:.3f} s ({prog.flow.m.n_cells} cells, {W} warm-up steps, CG "
        f"iterations {warm_iters})")

    rng = np.random.default_rng(int(ctx.seed) % (1 << 63))
    due = float(rng.uniform(0.0, ctx.seconds))
    tracer = ctx.tracer
    tracer.warm_up()
    kept, seg_iters = [], []
    steps = segments = 0
    iters_in_window = 0
    with tracer.window():
        t_start = time.perf_counter()
        seg_ends = [t_start]
        while True:
            keep = due is not None and time.perf_counter() - t_start >= due
            with tracer.span("restore"):
                prog.load(start)
            its = []
            for _ in range(K):
                with tracer.span("FlowSolver.advance"):
                    its.append(prog.step())
            iters_in_window += sum(sum(i) for i in its)
            steps += K
            segments += 1
            seg_ends.append(time.perf_counter())
            if keep or segments == 1:
                seg_iters.append(its)
            if keep:
                due = None
                kept.append((f"segment {segments - 1}",
                             {k: v.clone() for k, v in fields_of(prog.flow).items()}))
            if time.perf_counter() - t_start >= ctx.seconds:
                break
        with tracer.span("synchronize"):
            sync(dev)
        window_s = time.perf_counter() - t_start
    if not kept or kept[-1][0] != f"segment {segments - 1}":
        kept.append((f"segment {segments - 1}", fields_of(prog.flow)))
    kept[-1] = (kept[-1][0] + " (last)", kept[-1][1])
    peak = memory_peak(dev)
    summary = tracer.summary() if ctx.trace else None
    data = {"steps": steps, "cg_iterations": iters_in_window}
    e2e = {"flow_step_ms": window_s * 1e3 / steps, "setup_s": setup_s}
    seg_ms = np.diff(seg_ends) * 1e3 / K
    log(f"host clock a step by segment (issued; the last also drains): min "
        f"{seg_ms.min():.3f} median {np.median(seg_ms):.3f} max {seg_ms.max():.3f} ms")
    log(f"window: {segments} segments of {K} steps in {window_s:.4f} s; "
        f"{e2e['flow_step_ms']:.4f} ms a step; CG iterations a segment {seg_iters[0]}")
    kept = [(label, {k: v.clone() for k, v in f.items()}) for label, f in kept]
    del prog, start
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    failed = _check(ctx, case_dir, dtype, W, K, start_fields, warm_iters, seg_iters, kept)
    return Outcome(end_to_end=e2e, attempted=segments, failed=failed,
                   memory_peak_bytes=peak, data=data, trace=summary)


def field_errors(a: dict, b: dict) -> dict:
    """Per field: largest |a - b| over the largest |b| (the reference's)."""
    out = {}
    for k in FIELDS:
        if k in b:
            scale = float(b[k].abs().max())
            diff = float((a[k].to(b[k].dtype) - b[k]).abs().max())
            err = diff / scale if scale > 0 else diff
            out[k] = err if math.isfinite(err) else math.inf
    return out


def _check(ctx, case_dir, dtype, W, K, start_fields, warm_iters, seg_iters, kept) -> int:
    limits = ctx.config["limits"]
    ref = reference_stepper(case_dir, dtype, ctx.device)
    ref_warm = [ref.step() for _ in range(W)]
    e_start = field_errors(start_fields, fields_of(ref.flow))
    ref_seg = [ref.step() for _ in range(K)]
    ref_end = fields_of(ref.flow)
    worst, failed = max(e_start.values()), 0
    log(f"check start (after {W} warm-up steps): " +
        " ".join(f"{k}={v!r}" for k, v in e_start.items()))
    for label, f in kept:
        e = field_errors(f, ref_end)
        log(f"check {label}: " + " ".join(f"{k}={v!r}" for k, v in e.items()))
        worst = max(worst, max(e.values()))
        failed += int(not max(e.values()) <= limits["field_rel_error_max"])
    ours = warm_iters + [i for seg in seg_iters for i in seg]
    theirs = ref_warm + ref_seg * len(seg_iters)
    off = sum(int(a != b) for a, b in zip(ours, theirs)) + abs(len(ours) - len(theirs))
    log(f"check CG iterations: program {warm_iters} + {seg_iters[0]}, reference {ref_warm} + "
        f"{ref_seg}")
    ctx.checks.add("field_rel_error_max", worst, limits["field_rel_error_max"])
    ctx.checks.add("cg_iterations_off", off, limits["cg_iterations_off"])
    return failed
