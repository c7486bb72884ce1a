"""Readings that set a cell's limits: the compared numbers of sound runs of
the program over many seeds, and of the control (the reference in the
program's place at the next lower precision), in one process.

    python3 benchmark/tools/readings.py --workload box55.track --seconds 2 \
        --seeds 101 102 103 --control-seeds 201 202 203

Prints one JSON line per run ({"variant", "seed", "correct", "checks"})
and, last, the largest reading of each number per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spec  # noqa: E402
from harness.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    worst: dict = {}
    for variant, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            try:
                res = run_cell(cell, seed, args.seconds, False, args.device,
                               time.perf_counter(), variant=variant)
            except Exception as e:  # a control that crashes has failed; keep reading
                print(json.dumps({"variant": variant, "seed": seed, "error": repr(e)}),
                      flush=True)
                continue
            checks = {k: v["value"] for k, v in res["checks"].items()}
            print(json.dumps({"variant": variant, "seed": seed, "correct": res["correct"],
                              "checks": checks, "metrics": res["metrics"]}), flush=True)
            w = worst.setdefault(variant, {})
            for k, v in checks.items():
                w[k] = max(w.get(k, v), v) if variant == "program" else min(w.get(k, v), v)
    print(json.dumps({"largest_program_reading": worst.get("program"),
                      "smallest_control_reading": worst.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
