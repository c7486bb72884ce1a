"""Inputs of an OpenFOAM case configuration: a copy of the case's files
(``case`` in the configuration, a directory of the repository) in a cache
folder of the benchmark.

The copy is made once, at a fixed path (``benchmark/.cache/cases/<name>``),
and later runs find it there with whatever the program cached beside it.
Neither side writes into the repository's own ``tutorials/``.
"""

from __future__ import annotations

import os
import shutil

from harness import spec

CASES = os.path.join(spec.BENCH_DIR, ".cache", "cases")


def prepare(config: dict) -> str:
    """The case directory of ``config``, copied on first use."""
    dst = os.path.join(CASES, config["name"])
    if os.path.isfile(os.path.join(dst, ".ready")):
        return dst
    src = os.path.join(spec.ROOT, config["case"])
    tmp = f"{dst}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(src, tmp)
    # where blockMesh would write its mesh
    os.makedirs(os.path.join(tmp, "constant", "polyMesh"), exist_ok=True)
    open(os.path.join(tmp, ".ready"), "w").close()
    shutil.rmtree(dst, ignore_errors=True)
    os.replace(tmp, dst)
    return dst
