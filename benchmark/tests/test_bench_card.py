"""On the card: a box cell at a test's size runs its kernels and agrees
with the reference, and the traced run reads its per-layer metrics from the
profile.  Skips without a card."""

import time

import pytest

from harness.run import run_cell


@pytest.mark.card
def test_box_cell_on_the_card(card, small_box):
    cell = small_box("box55.track", 12, 20_000)
    res = run_cell(cell, 2**31 + 5, 1.0, False, card, time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["particle_steps_per_s"]["value"] > 0


@pytest.mark.card
def test_traced_box_cell_on_the_card(card, small_box):
    cell = small_box("box55.saves", 12, 20_000)
    res = run_cell(cell, 2**31 + 6, 1.0, True, card, time.perf_counter())
    assert res["correct"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert {"launches_per_cycle.particles", "device_idle_share.particles",
            "stream_kernel_roofline.particles"} <= set(res["metrics"])
    assert 0 < res["metrics"]["stream_kernel_roofline.particles"]["value"] <= 105
