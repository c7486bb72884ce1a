"""Modules a run must not have loaded: the JAX stack and the JAX package
the port was made from.  Names are compared by their top-level part, the
part before the first dot, whole: ``cudaparticlesfoam_tpu_torch`` is the
program and is allowed, ``cudaparticlesfoam_tpu`` is not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cudaparticlesfoam_tpu"})


class ForbiddenModules(RuntimeError):
    """The run loaded a module the benchmark forbids."""


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names of ``modules`` (default ``sys.modules``) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
