"""The multi-device dry run of the port (the twin of
``__graft_entry__.py``'s ``dryrun_multichip``): one step of each
multi-device path on tiny shapes over ``n_devices`` shards.

    python -c "from cudaparticlesfoam_tpu_torch import dryrun; dryrun.dryrun_multichip(4)"

The shards lie on the card (``cuda:0 x4`` on one card, the visible cards
in turn on more) unless ``device="cpu"`` asks for the CPU; never on the CPU
when the card was asked for and is missing.  The three legs:

1. data-parallel particles (``parallel/sharding.py``) against a
   single-device run of the same state, one cycle;
2. the slab-partitioned mesh with migration (``parallel/partition.py``):
   two cycles and a settle step, collected, against the single-device
   trajectory (advection only: the partitioned noise is keyed by particle
   id);
3. the domain-decomposed PIMPLE step (``parallel/flowshard.py``) on a
   24 x 3 x 3 duct: finite, continuity below 1e-3.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

DUCT_BMD = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
convertToMeters 1;
vertices ( (0 0 0) (6 0 0) (6 1 0) (0 1 0) (0 0 1) (6 0 1) (6 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (24 3 3) simpleGrading (1 1 1) );
boundary (
  inlet  { type patch; faces ((0 4 7 3)); }
  outlet { type patch; faces ((1 2 6 5)); }
  walls  { type wall;  faces ((0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7)); }
);
"""


def _tiny_problem(device, n_box=4, n_particles=512):
    """A 4^3 box (384 tets) and located seeds in its middle."""
    from . import box_mesh, build_grid_locator, locate_seeds, seed_in_box

    mesh = box_mesh(n_box, n_box, n_box, device=device)
    st = seed_in_box(n_particles, (0.2 * n_box,) * 3, (0.8 * n_box,) * 3, device=device)
    tet = locate_seeds(mesh, build_grid_locator(mesh), st.pos)
    return mesh, dataclasses.replace(st, tet_id=tet)


def dryrun_multichip(n_devices: int, device=None, log=print) -> dict:
    """Run the three legs on ``n_devices`` shards of ``device`` (default the
    card); raises on any disagreement.  Returns the numbers it checked."""
    from . import run_cycles
    from .dtypes import canonical_device
    from .io import blockmesh
    from .models import fv
    from .models.pimple import PimpleConfig
    from .parallel import flowshard, partition, sharding
    from .stepper import StepConfig

    device = canonical_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no usable CUDA device; pass device='cpu'")
    devices = sharding.make_device_mesh(n_devices, device)
    mesh, state = _tiny_problem(device, n_particles=64 * n_devices)
    cfg = StepConfig(dt=0.05, diffusion_coeff=1e-4)

    # leg 1: data-parallel particles against the single-device trajectory
    meshes = sharding.replicate_mesh(mesh, devices)
    shards = sharding.shard_state(state, devices)
    out = sharding.run_cycles_sharded(meshes, shards, cfg, 1)
    diag = sharding.global_diagnostics(out)
    if int(diag["active"]) <= 0:
        raise AssertionError("dryrun_multichip: no active particle after the DP step")
    ref = run_cycles(mesh, state, cfg, 1)
    n0 = state.n_particles
    pos = torch.cat([s.pos.to(device) for s in out])[:n0]
    tet = torch.cat([s.tet_id.to(device) for s in out])[:n0]
    act = torch.cat([s.active.to(device) for s in out])[:n0]
    dp_err = float((pos - ref.pos).abs().max())
    if dp_err > 1e-6 or not torch.equal(tet, ref.tet_id) or not torch.equal(act, ref.active):
        raise AssertionError(f"dryrun_multichip: DP diverges from the single-device "
                             f"trajectory (pos {dp_err:.3e})")

    # leg 2: the partitioned mesh with migration, advection only
    cfg_nb = dataclasses.replace(cfg, use_brownian=False)
    pmesh = partition.partition_mesh(mesh, n_devices)
    sp = partition.distribute_particles(pmesh, state.pos, state.vel, state.tet_id, state.active,
                                        seed=state.seed)
    pmesh, sp = partition.shard_arrays(pmesh, sp, devices)
    pstep = partition.make_partitioned_step(pmesh, cfg_nb, devices)
    sp, mig = pstep(pmesh, sp, 0.05)
    sp, _ = pstep(pmesh, sp, 0.05)
    sp, _ = partition.make_settle_step(pmesh, cfg_nb, devices)(pmesh, sp, 0.0)
    resident = sum(int(r.sum()) for r in sp.resident)
    ppos, _pv, ptet, _pa = partition.collect_particles(pmesh, sp, n0)
    pref = run_cycles(mesh, state, cfg_nb, 2)
    part_err = float(np.abs(ppos - pref.pos.cpu().numpy()).max())
    if resident != n0 or part_err > 1e-6 or not (ptet == pref.tet_id.cpu().numpy()).all():
        raise AssertionError(f"dryrun_multichip: partitioned run diverges ({resident} of {n0} "
                             f"resident, pos {part_err:.3e})")

    # leg 3: the domain-decomposed PIMPLE step on a small duct
    with tempfile.TemporaryDirectory() as tdir:
        path = os.path.join(tdir, "blockMeshDict")
        with open(path, "w") as fh:
            fh.write(DUCT_BMD)
        pm = blockmesh.generate(path)
    gm = fv.fv_mesh(pm, device=devices[0])
    u_bcs = fv.make_bcs(gm, {"inlet": ("fixedValue", [1.0, 0.0, 0.0]),
                             "walls": ("noSlip", 0.0)}, 3)
    p_bcs = fv.make_bcs(gm, {"outlet": ("fixedValue", 0.0)}, 1)
    smesh, bglob = flowshard.decompose(pm, n_devices, devices=devices)
    u_bcs_s = flowshard.shard_bcs(u_bcs, bglob, smesh)
    p_bcs_s = flowshard.shard_bcs(p_bcs, bglob, smesh)
    u_s = flowshard.scatter_cells(smesh, np.tile([1.0, 0.0, 0.0], (pm.n_cells, 1)))
    p_s = flowshard.scatter_cells(smesh, np.zeros(pm.n_cells))
    flux_s = flowshard.flux_init(smesh, u_s, u_bcs_s)
    step = flowshard.make_sharded_pimple(smesh, PimpleConfig(nu=1e-3, div_scheme="linearUpwind"))
    u_s, p_s, flux_s, fdiag = step(smesh, u_s, p_s, flux_s, u_bcs_s, p_bcs_s, 0.02)
    u_g = flowshard.gather_cells(smesh, u_s)
    cont = float(fdiag["continuity"])
    if not bool(torch.isfinite(u_g).all()) or not cont < 1e-3:
        raise AssertionError(f"dryrun_multichip: sharded PIMPLE continuity {cont}")

    res = {"devices": [str(d) for d in devices], "particles": n0,
           "active": int(diag["active"]), "out_of_domain": int(diag["out_of_domain"]),
           "dp_max_abs_err": dp_err, "partitioned_max_abs_err": part_err,
           "migrated": int(mig["migrated"]), "deferred": int(mig["deferred"]),
           "n_tets": pmesh.n_tets, "n_cells": pm.n_cells, "continuity": cont,
           "p_iters": list(fdiag["p_iters"])}
    log(f"dryrun_multichip ok: {n_devices} shards [{sharding.placement(devices)}], "
        f"{n0} particles DP (active={res['active']}, out_of_domain={res['out_of_domain']}, "
        f"max_abs_err={dp_err:.3e}); partitioned step ok ({pmesh.n_tets} tets over "
        f"{n_devices} shards, migrated={res['migrated']}, deferred={res['deferred']}, "
        f"max_abs_err={part_err:.3e}); sharded PIMPLE ok ({pm.n_cells} cells over "
        f"{n_devices} shards, continuity={cont:.2e})")
    return res
