"""The program's flow over a case's course: step time, deltaT and CG
iterations of every stretch of ``--every`` steps from the initial fields to
``--until`` seconds of simulated time, on one card.

    python3 benchmark/tools/flow_course.py --workload tjunction.flow --until 0.65 --every 10 --first 3

``--first N`` takes N untimed steps before the first stretch, so that with
``--first 3 --every 10`` the first stretch is the flow cell's segment.
Each stretch is timed by the host clock between two synchronizes.  With
``--reference-steps N`` the plain reference then takes N steps from the
initial fields, timed the same way.  Prints one JSON line a stretch, then
a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spec  # noqa: E402
from harness.run import sync  # noqa: E402


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", default="tjunction.flow")
    p.add_argument("--until", type=float, default=0.5)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--max-steps", type=int, default=20000)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--reference-steps", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    flow = spec.load_module("drivers", "flow")
    dtype = {"float32": torch.float32, "float64": torch.float64}[cell.config["flow_dtype"]]
    case_dir = spec.load_module("builders", cell.config["builder"]).prepare(cell.config)
    ctx = types.SimpleNamespace(device=args.device, program=lambda: _program())
    prog = flow.program_stepper(ctx, case_dir, dtype)
    for _ in range(args.first):
        prog.step()
    steps, rows = args.first, []
    while prog.flow.time < args.until and steps < args.max_steps:
        sync(args.device)
        t0 = time.perf_counter()
        iters, dts = [], []
        for _ in range(args.every):
            dt = prog.dt()
            dts.append(dt)
            iters.append(sum(prog.step_at(dt)))
        sync(args.device)
        ms = (time.perf_counter() - t0) * 1e3 / args.every
        steps += args.every
        row = {"steps": steps, "time": prog.flow.time, "dt_last": dts[-1],
               "step_ms": ms, "cg_iterations_per_step": sum(iters) / len(iters)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"steps": steps, "time": prog.flow.time,
                      "median_step_ms": statistics.median(r["step_ms"] for r in rows)}),
          flush=True)
    del prog
    if args.reference_steps:
        t0 = time.perf_counter()
        ref = flow.reference_stepper(case_dir, dtype, args.device)
        sync(args.device)
        t1 = time.perf_counter()
        for _ in range(args.reference_steps):
            ref.step()
        sync(args.device)
        t2 = time.perf_counter()
        print(json.dumps({"reference_build_s": t1 - t0, "reference_steps": args.reference_steps,
                          "reference_step_ms": (t2 - t1) * 1e3 / args.reference_steps}),
              flush=True)
    return 0


def _program():
    if spec.ROOT not in sys.path:
        sys.path.insert(0, spec.ROOT)
    import cudaparticlesfoam_tpu_torch

    return cudaparticlesfoam_tpu_torch


if __name__ == "__main__":
    sys.exit(main())
