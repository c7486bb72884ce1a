"""One run of one cell: set-up, the measured window, the check, the line.

``main`` is the command line (``benchmark/run.py``); ``run_cell`` is the
rest of a run without the look for a chip, which the tests drive on the
CPU at a small size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from . import guard, spec
from .checks import Checks
from .trace import Tracer

CACHE_DIR = os.path.join(spec.BENCH_DIR, ".cache")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 on the CPU)."""
    import torch

    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and its tools."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                  # perf_counter at process start
    tracer: Tracer
    checks: Checks
    variant: str = "program"   # "control": the reference in lower precision in its place

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def program(self):
        """The system under test, ``cudaparticlesfoam_tpu_torch``."""
        if spec.ROOT not in sys.path:
            sys.path.insert(0, spec.ROOT)
        import cudaparticlesfoam_tpu_torch

        return cudaparticlesfoam_tpu_torch


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    end_to_end: dict            # metric name -> value (host clock)
    attempted: int
    failed: int
    memory_peak_bytes: int
    data: dict = dataclasses.field(default_factory=dict)   # for the metric readers
    trace: dict | None = None   # Tracer.summary()


def _environment() -> None:
    """Caches inside the checkout, at fixed paths."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, variant: str = "program") -> dict:
    """Run ``cell`` once on ``device`` and return the result line's object
    (``checks`` last).  Prints the compared numbers as the last lines on
    standard error."""
    import torch

    ctx = Context(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=device, t0=t0, tracer=Tracer(trace, device), checks=Checks(),
                  variant=variant)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    out: Outcome = driver.run(ctx)
    _record_setup(cell, ctx, out)
    metrics = {}
    if trace:
        summary = out.trace
        out.data["trace"] = summary
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(out.data)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": ctx.checks.correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = ctx.checks.as_dict()
    # last, once the readers have run: whatever they loaded counts too
    found = guard.forbidden_loaded()
    if found:
        raise guard.ForbiddenModules(f"the run loaded {found}, which the benchmark forbids")
    ctx.checks.print_last()
    return result


def _record_setup(cell: spec.Cell, ctx: Context, out: Outcome) -> None:
    """Log the set-up, and the program's kernel build apart from it when
    this run built them (a checkout's first run), and append both to
    ``.cache/setup.jsonl``."""
    setup_s = out.end_to_end.get("setup_s")
    build = sys.modules.get("cudaparticlesfoam_tpu_torch.ops._build")
    built = bool(build and build.ptxas_report())
    build_s = build._LIB.get("seconds") if build else None
    if setup_s is None:
        return
    log(f"set-up {setup_s:.3f} s; kernel library "
        + (f"built in this run: {build_s:.3f} s of it (a checkout's first run)" if built
           else "found built" if build_s is not None else "not loaded"))
    if ctx.device == "cpu":
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    with open(os.path.join(CACHE_DIR, "setup.jsonl"), "a") as fh:
        fh.write(json.dumps({"workload": cell.name, "seed": ctx.seed, "setup_s": setup_s,
                             "kernels_built": built, "build_s": build_s}) + "\n")


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    _environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), this machine has "
            f"{have}; no result")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    except guard.ForbiddenModules as e:
        log(f"benchmark: {e}; no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0

