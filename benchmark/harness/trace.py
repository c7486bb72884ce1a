"""The traced run's readings: host spans of the benchmark's own calls into
the program, and the device's activity from ``torch.profiler``.

Spans are kept in memory as (name, start ns, end ns) on the wall clock
(``time.time_ns``), which is the clock the profiler stamps its events with.
The device's busy time is the union of its activity intervals (kernels,
copies and fills); an idle gap is a stretch between them, named by the
benchmark span the host was in when it began.
"""

from __future__ import annotations

import contextlib
import re
import time

import torch


def short_kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    template and call arguments: ``void stream_kernel<float, ...>(...)`` ->
    ``stream_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = name.split("(")[0]
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:96] or name[:96]


def find_kernel(kernels: dict, name: str) -> tuple[int, float]:
    """(count, seconds) of kernel ``name`` in a summary's ``kernels``: the
    entries whose short name is ``name`` or ends in ``::name``."""
    count, seconds = 0, 0.0
    for k, (c, s) in kernels.items():
        if k == name or k.endswith("::" + name):
            count, seconds = count + c, seconds + s
    return count, seconds


def idle_share_percent(summary: dict | None) -> float | None:
    """Percent of a traced window in which no operation ran on the device."""
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_events(prof):
    """(name, start ns, end ns) of every device activity the profile holds."""
    from torch.autograd import DeviceType

    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                out.append((e.name(), int(e.start_ns()), int(e.end_ns())))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return out


class Tracer:
    """Spans and, with ``on``, a profile of the measured window."""

    def __init__(self, on: bool, device):
        self.on = bool(on) and torch.device(device).type == "cuda"
        self.spans: list[tuple[str, int, int]] = []
        self.window_ns = None
        self.events = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def warm_up(self) -> None:
        """Start and stop the profiler once, so that its first start, which
        loads the tracing library, falls in the set-up and not the window."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        """Profile what runs inside; the caller synchronises before it leaves
        the block, so the window's end follows the device's last work."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            yield
            t1 = time.time_ns()
        self.window_ns = (t0, t1)
        self.events = device_events(prof)

    def summary(self) -> dict | None:
        """busy_s, window_s, kernels by short name {name: [count, seconds]},
        the kernel count, the ten longest idle gaps [[label, seconds]] and the
        ten busiest device operations [[name, seconds]]."""
        if self.window_ns is None:
            return None
        w0, w1 = self.window_ns
        merged = _union([(s, e) for _, s, e in self.events if e > s])
        busy_ns = sum(e - s for s, e in merged)
        kernels: dict[str, list] = {}
        for name, s, e in self.events:
            k = kernels.setdefault(short_kernel_name(name), [0, 0.0])
            k[0] += 1
            k[1] += (e - s) / 1e9
        aligned = bool(merged) and w0 - 10**9 <= merged[0][0] <= w1 + 10**9
        edges = [(w0, w0)] if aligned else []
        edges += [tuple(iv) for iv in merged]
        edges += [(w1, w1)] if aligned else []
        gaps = []
        for (_, e_prev), (s_next, _) in zip(edges, edges[1:]):
            if s_next > e_prev:
                gaps.append((s_next - e_prev, e_prev))
        gaps.sort(reverse=True)
        labelled = [[f"host in {self._host_at(start) if aligned else 'unknown'}", g / 1e9]
                    for g, start in gaps[:10]]
        ops = sorted(([n, v[1]] for n, v in kernels.items()), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9, "kernels": kernels,
                "n_device_ops": len(self.events), "idle_gaps": labelled, "device_ops": ops,
                "clock_aligned": aligned}

    def _host_at(self, t_ns: int) -> str:
        inside = [name for name, s, e in self.spans if s <= t_ns <= e]
        return inside[-1] if inside else "the benchmark, outside its spans"
