"""Shared fixtures of the benchmark's tests.

The marker ``card`` marks a test that needs an NVIDIA card; the ``card``
fixture decides, when the test runs, whether one is there, and skips it on
the CPU.  Run them on the card with

    python3 -m pytest benchmark/tests -m card -q -p no:cacheprovider
"""

import os
import shutil
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

TJUNCTION = os.path.join(ROOT, "tutorials", "incompressible", "cudaParticlesPimpleFoam",
                         "TJunction")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return "cuda"


@pytest.fixture
def small_box():
    """A box cell cut to a test's size: ``small_box("box55.track", 4, 300)``."""
    def make(workload, n_side=4, n_particles=300):
        cell = spec.load_cell(workload)
        cell.config = {**cell.config, "n_side": n_side, "n_particles": n_particles}
        return cell
    return make


@pytest.fixture
def small_tjunction(tmp_path, monkeypatch):
    """A TJunction cell on the case shrunk to 1,984 cells, its case copy
    under the test's temporary folder: ``small_tjunction("tjunction.flow")``."""
    case = tmp_path / "TJunction"
    shutil.copytree(TJUNCTION, case)
    bmd = case / "system" / "blockMeshDict"
    text = bmd.read_text()
    for a, b in (("(200 20 20)", "(40 4 4)"), ("(20 20 20)", "(4 4 4)"), ("(20 200 20)", "(4 40 4)")):
        text = text.replace(a, b)
    bmd.write_text(text)
    builder = spec.load_module("builders", "foam_case")
    monkeypatch.setattr(builder, "CASES", str(tmp_path / "cases"))

    def make(workload="tjunction.flow"):
        cell = spec.load_cell(workload)
        cell.config = {**cell.config, "case": str(case), "name": "tjunction-test"}
        return cell
    return make
