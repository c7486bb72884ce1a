"""Command-line entry points of the PyTorch/CUDA port (port of
``cudaparticlesfoam_tpu/cli.py``).

Replaces the reference's OpenFOAM executables and Allrun scripts:

    python -m cudaparticlesfoam_tpu_torch uncoupled <case>   # cudaParticlesUncoupledFoam
    python -m cudaparticlesfoam_tpu_torch coupled <case>     # cudaParticlesPimpleFoam
    python -m cudaparticlesfoam_tpu_torch replay <case>      # particles over recorded U
    python -m cudaparticlesfoam_tpu_torch blockmesh <case>   # blockMesh
    python -m cudaparticlesfoam_tpu_torch simple <case>      # steady flow (simpleFoam)
    python -m cudaparticlesfoam_tpu_torch dict <file> -entry <key> [-set <value>]

``uncoupled``, ``coupled``, ``replay`` and ``simple`` run on the card
unless ``--device cpu`` asks for the CPU (the kernels' plain versions,
torch ops on the CPU); ``--f64`` runs in float64 (``coupled`` solves its
flow in float32 all the same, as the JAX package does).  ``--devices N``
and ``--strategy dp|partitioned`` run the particles on N shards
(``parallel/``; on the card the shards share the visible cards in turn,
on ``--device cpu`` they all run on the CPU).  ``--flow-devices N>1``
raises: the domain-decomposed flow solve is not ported yet (ROADMAP.md
queue 1 item 13c).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cudaparticlesfoam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_case_cmd(name, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("case", help="OpenFOAM-style case directory")
        p.add_argument("--out", default=None, help="output directory")
        p.add_argument("--no-write", action="store_true", help="skip VTU output")
        p.add_argument("--f64", action="store_true", help="run in float64 (parity mode)")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; 'cpu' runs the plain versions)")
        return p

    def add_particle_parallel(p):
        p.add_argument("--devices", type=int, default=None,
                       help="particle shards (default one per visible card); more shards "
                            "than cards share them in turn")
        p.add_argument("--strategy", default="auto",
                       choices=("auto", "single", "dp", "partitioned"),
                       help="multi-device strategy: particle data parallelism (dp), the "
                            "slab-partitioned mesh (partitioned), or chosen from the memory "
                            "model (auto)")

    p = add_case_cmd("uncoupled", "frozen-field particle tracking")
    p.add_argument("--profile", default=None, help="write a torch.profiler trace here")
    add_particle_parallel(p)
    p = add_case_cmd("replay", "particle tracking over recorded U snapshots")
    add_particle_parallel(p)
    p = add_case_cmd("coupled", "PIMPLE flow + particle tracking")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--flow-devices", type=int, default=None,
                   help="domain-decomposed flow devices; more than one is not ported yet")
    add_particle_parallel(p)

    # --out and --no-write are accepted and unused, as in the JAX CLI
    p = add_case_cmd("simple", "steady incompressible flow (SIMPLE)")
    p.add_argument("--iters", type=int, default=None)

    p = sub.add_parser("blockmesh", help="generate constant/polyMesh from blockMeshDict")
    p.add_argument("case")

    p = sub.add_parser(
        "dict", help="read/modify a dictionary entry (foamDictionary equivalent)"
    )
    p.add_argument("file")
    p.add_argument("-entry", required=True)
    p.add_argument("-set", dest="value", default=None)

    args = ap.parse_args(argv)

    if args.cmd == "dict":
        from .io import foamfile

        d = foamfile.read(args.file)
        obj = d.pop("FoamFile", {}).get("object") or os.path.basename(args.file)
        if args.value is None:
            print(d.get(args.entry))
            return 0
        try:
            val = float(args.value)
            val = int(val) if val.is_integer() and "." not in args.value else val
        except ValueError:
            val = args.value
        d[args.entry] = val
        foamfile.write(args.file, d, obj_name=str(obj))
        return 0

    if args.cmd == "blockmesh":
        from .io import blockmesh, polymesh

        pm = blockmesh.generate(os.path.join(args.case, "system", "blockMeshDict"))
        out = os.path.join(args.case, "constant", "polyMesh")
        polymesh.write_polymesh(pm, out)
        print(f"wrote {pm.n_cells} cells to {out}")
        return 0

    dtype = "float64" if args.f64 else None
    if args.cmd == "simple":
        from .models import simple

        simple.run(args.case, n_iters=args.iters, dtype=dtype, device=args.device)
        return 0

    if args.cmd == "replay":
        from .models import coupled

        coupled.run_replay(args.case, out_dir=args.out, write_output=not args.no_write,
                           dtype=dtype, devices=args.devices, strategy=args.strategy,
                           device=args.device)
        return 0
    if args.cmd == "coupled":
        from .models import coupled

        coupled.run_coupled(args.case, out_dir=args.out, write_output=not args.no_write,
                            dtype=dtype, n_steps=args.steps, flow_devices=args.flow_devices,
                            devices=args.devices, strategy=args.strategy, device=args.device)
        return 0

    from .models import uncoupled

    uncoupled.run(
        args.case,
        out_dir=args.out,
        write_output=not args.no_write,
        dtype=dtype,
        profile_dir=args.profile,
        devices=args.devices,
        strategy=args.strategy,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
