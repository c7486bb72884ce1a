"""The numbers that decide ``correct``, each beside its limit."""

from __future__ import annotations

import math
import sys


class Checks:
    """Each compared number with its limit; a run is correct when every one
    is present, finite and at most its limit."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(math.isfinite(v) and v <= lim
                                        for _, v, lim in self.items)

    def failed_names(self) -> list[str]:
        return [n for n, v, lim in self.items if not (math.isfinite(v) and v <= lim)]

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def print_last(self, stream=sys.stderr) -> None:
        for n, v, lim in self.items:
            ok = "ok" if math.isfinite(v) and v <= lim else "FAILED"
            print(f"check {n}: {v!r} (limit {lim!r}) {ok}", file=stream)
        print(f"correct: {self.correct}", file=stream, flush=True)
