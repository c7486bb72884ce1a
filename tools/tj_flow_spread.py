"""How far apart two float32 flow steps of the TJunction land, on the card.

Builds the TJunction tutorial at full width (248,000 cells; ``--small``:
the shrunk case of the tests, on the CPU) and runs Eulerian step 1 from the
case's fields with the single-device ``FlowSolver`` and the 4-shard
``ShardedFlowSolver``, each twice from scratch, in float32 and once in
float64, all with the single solver's dt; then the same float32 runs with
the face-to-cell sums outside the pressure solve done by ``index_add_``
(the port's sums before ``fv.index_sum`` fixed their order on the card),
and with the pressure solve op by op as before its kernels
(``chip_smoke.AmgMode("op-by-op")``: ``torch.segment_reduce`` a row, which
sums a 1-d row as a tree on the card, where ``csrc/amg.cu`` sums it left to
right).  Prints each run's step seconds and CG counts, and for pairs of
runs the velocity's rel-max difference (max |dU| / max |U|, chip_smoke
13b's step-1 measure) and whether they are identical bit for bit.

    python tools/tj_flow_spread.py            # on the card
    python tools/tj_flow_spread.py --small    # the shrunk case on the CPU
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import coupled, fv, pimple  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard  # noqa: E402


def index_add_sums(n_out, parts, out=None, drop=False):
    """``fv.index_sum`` with ``index_add_`` on every device (its CPU path)."""
    vals = [v for _, v in parts]
    v0 = vals[0]
    idxs, n = [i for i, _ in parts], n_out
    if drop:
        idxs, n = [torch.where((i >= 0) & (i < n_out), i, n_out) for i in idxs], n_out + 1
    res = (v0.new_zeros((n,) + tuple(v0.shape[1:])) if out is None
           else torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))]) if drop
           else out.clone())
    for i, v in zip(idxs, vals):
        res.index_add_(0, i, v)
    return res[:n_out]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true", help="the shrunk TJunction on the CPU")
    args = ap.parse_args()
    dev = torch.device("cpu" if args.small else "cuda:0")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    quiet = lambda *a: None  # noqa: E731
    tmp = tempfile.mkdtemp()
    case = chip_smoke.tjunction_case(torch, tmp, args.small)
    res, _ = chip_smoke.cli(["blockmesh", case])
    if res.returncode:
        sys.exit(f"blockmesh failed: {res.stderr[-2000:]}")
    tcase, _ = coupled._load(case, None, quiet, dev)
    if dev.type == "cuda":
        print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
              .read().strip())

    fixed_sums, out, dt = fv.index_sum, {}, []

    def run(name, kind, dtype=None, sums=fixed_sums, steps=1, mode="graph"):
        fv.index_sum = sums
        try:
            with chip_smoke.AmgMode(fv, flowshard, mode):
                flow = (pimple.FlowSolver.from_case(tcase, log=quiet, device=dev, dtype=dtype)
                        if kind == "single" else
                        flowshard.ShardedFlowSolver(tcase, chip_smoke.FLOW_SHARDS, log=quiet,
                                                    device=dev, dtype=dtype))
                if not dt:
                    dt.append(flow.stable_dt(tcase.control))
                secs, its = [], []
                for k in range(steps):
                    sync()
                    t0 = time.perf_counter()
                    r = flow.advance(dt[0])
                    sync()
                    secs.append(time.perf_counter() - t0)
                    its.append(r["p_iters"])
                    if k == 0:
                        out[name] = (fv.host(flow.state.u).astype(np.float64),
                                     fv.host(flow.state.p).astype(np.float64))
        finally:
            fv.index_sum = fixed_sums
        print(f"{name}: step_s={[round(s, 3) for s in secs]} cg_iterations={its}", flush=True)

    run("single_f32", "single", steps=3)
    run("single_f32_again", "single")
    run("single_f32_index_add", "single", sums=index_add_sums, steps=3)
    run("single_f32_index_add_again", "single", sums=index_add_sums)
    run("single_f32_op_by_op", "single", mode="op-by-op")
    run("single_f64", "single", torch.float64)
    run("sharded_f32", "sharded", steps=3)
    run("sharded_f32_again", "sharded")
    run("sharded_f32_index_add", "sharded", sums=index_add_sums, steps=3)
    run("sharded_f32_index_add_again", "sharded", sums=index_add_sums)
    run("sharded_f32_op_by_op", "sharded", mode="op-by-op")
    run("sharded_f64", "sharded", torch.float64)
    for a, b in [("single_f32", "single_f32_again"), ("sharded_f32", "sharded_f32_again"),
                 ("single_f32_index_add", "single_f32_index_add_again"),
                 ("sharded_f32_index_add", "sharded_f32_index_add_again"),
                 ("single_f32", "sharded_f32"), ("single_f32_again", "sharded_f32_again"),
                 ("single_f32_index_add", "sharded_f32_index_add"),
                 ("single_f32_index_add_again", "sharded_f32_index_add_again"),
                 ("single_f32", "single_f32_index_add"), ("sharded_f32", "sharded_f32_index_add"),
                 ("single_f32_op_by_op", "sharded_f32_op_by_op"),
                 ("single_f32", "single_f32_op_by_op"), ("sharded_f32", "sharded_f32_op_by_op"),
                 ("single_f64", "single_f32"), ("single_f64", "sharded_f32"),
                 ("single_f64", "sharded_f64")]:
        ua, ub = out[a][0], out[b][0]
        same = bool(np.array_equal(ua, ub) and np.array_equal(out[a][1], out[b][1]))
        print(f"{a} vs {b}: u_rel_max={np.abs(ua - ub).max() / np.abs(ua).max():.4e} "
              f"identical={int(same)}", flush=True)


if __name__ == "__main__":
    main()
