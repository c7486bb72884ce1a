"""Phase timing + profiler integration (port of
``cudaparticlesfoam_tpu/utils/profiling.py``).

Makes real what the reference left commented out: the per-phase
performance report (``src/advect.H:186-203`` — BVH/Adv/Dfs/Qry/Rft/Mov/IO
table with fractions) and the cudaEvent timers (``cuda/cudaHelpers.cuh:44-87``).
The table reports the pipeline stages of a run (mesh build, seeding, the
advect loop, I/O); :func:`device_trace` gives the op-level device times.

On the card PyTorch launches asynchronously, so the host's clock around a
phase is the time to *issue* its work.  There :class:`PhaseTimer` also
records a pair of CUDA events around every phase, and a phase's time is the
span between them on the device's stream: it includes the phase's device
work and costs no synchronisation while the run goes on.  The host's times
are kept beside them (``host``); where the two are equal, the host bounds
the phase.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class PhaseTimer:
    """Accumulating phase timer with a reference-style report.

    ``device``: where the run's tensors live.  On a CUDA device ``totals``
    holds the device spans (CUDA events) once :meth:`resolve` has run
    (:meth:`report` runs it); elsewhere ``totals`` is the host's wall
    clock, as in the JAX package.  ``host`` is always the host's clock."""

    def __init__(self, device=None):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.host: dict[str, float] = {}
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = torch.device(device) if self._cuda else None
        self._events: list = []      # (name, start event, end event), not yet resolved

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    @contextlib.contextmanager
    def phase(self, name: str):
        e0 = self._event() if self._cuda else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.host[name] = self.host.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self._cuda:
                self._events.append((name, e0, self._event()))
                self.totals.setdefault(name, 0.0)
            else:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.host[name] = self.host.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def resolve(self) -> dict:
        """Fold the recorded CUDA event pairs into ``totals`` (one wait for
        the last event); returns ``totals``."""
        if self._events:
            self._events[-1][2].synchronize()
            for name, e0, e1 in self._events:
                self.totals[name] += e0.elapsed_time(e1) * 1e-3
            self._events = []
        return self.totals

    def report(self, log=print, exclude_io: bool = True):
        """Print the fraction table (cf. the reference's intended report at
        ``advect.H:193-202``: 'IO is not included to compute time fraction');
        on the card with the host's time to issue each phase beside it."""
        self.resolve()
        compute = {
            k: v for k, v in self.totals.items() if not (exclude_io and k == "IO")
        }
        total = sum(compute.values())
        log("\tItem\ttime(s)\tfraction(%)" + ("\thost(s)" if self._cuda else ""))
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            if exclude_io and name == "IO":
                continue
            frac = 100.0 * t / total if total > 0 else 0.0
            host = f"\t{self.host[name]:.2f}" if self._cuda else ""
            log(f"\t{name}\t{t:.2f}\t{frac:.2f}{host}")
        if "IO" in self.totals:
            host = f"\t\t{self.host['IO']:.2f}" if self._cuda else ""
            log(f"\tIO\t{self.totals['IO']:.2f}{host}")
        log(f"\tTotal Time = {total*1e3:.2f} ms")
        return total


@contextlib.contextmanager
def device_trace(out_dir: str | None, device=None):
    """Optional ``torch.profiler`` trace around a region (op-level device
    times — the deep version of the reference's cudaTimer): CPU activity,
    and CUDA activity when ``device`` is a CUDA device; the Chrome trace
    lands in ``out_dir/trace.json``."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
