"""The cell a run measures, found by name from ``BENCHMARK.json``.

A cell names a configuration (a JSON file under ``configs/``, given by the
configuration's ``file``) and a traffic mix (``traffic/<mix>.json``).  The
mix names the driver that runs it (``drivers/<driver>.py``) and the
configuration the builder of its inputs (``builders/<builder>.py``).  Each
per-layer metric is read by ``metrics/<metric name>.py``.  Adding any of
them is adding a file; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """A name that BENCHMARK.json or a file under the benchmark refuses."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r} is not a name: 1 to 64 letters, digits, "
                        f"'_', '.' or '-', starting with a letter, a digit or '_'")
    return name


def _read_json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"no {what} at {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


_MODULES: dict = {}


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, imported by its path (a
    name may hold dots, which an import statement would read as packages),
    once a process."""
    check_name(name, kind[:-1])
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if path in _MODULES:
        return _MODULES[path]
    if not os.path.isfile(path):
        raise SpecError(f"no {kind[:-1]} {name!r}: {os.path.relpath(path, ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list      # metric entries that this cell reports with --trace 0
    per_layer: list       # ... and with --trace 1


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without a list: every cell that reports what it moves
    return metric.get("moves", None) in reported if "moves" in metric else True


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of ``bench``)."""
    check_name(workload, "workload")
    if bench is None:
        bench = _read_json(os.path.join(ROOT, "BENCHMARK.json"), "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json; there are "
                        f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload!r} names configuration {w['config']!r}, "
                        f"which BENCHMARK.json does not list")
    centry = configs[w["config"]]
    config = _read_json(os.path.join(ROOT, centry["file"]), f"configuration {w['config']!r}")
    traffic_name = check_name(w["traffic"], "traffic")
    traffic = _read_json(os.path.join(BENCH_DIR, "traffic", f"{traffic_name}.json"),
                         f"traffic mix {traffic_name!r}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())
           or m["name"] == "setup_s"]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=traffic_name, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)
