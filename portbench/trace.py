"""Spans and the device trace, taken from outside the program.

``Tap`` stands in for a module-global function of the program (the fused
layer, the kernel encoding) and calls hooks around it.  ``device_window``
runs a call under ``torch.profiler`` with the CUDA activity alone and
reduces its device events in memory: kernel launches, device seconds by
kernel name, the busy union, and the idle time by the stage the host was
in, from host marks on the profiler's clock (Unix nanoseconds)."""

from __future__ import annotations

import bisect
import time


class Tap:
    """Calls `real` with `on_enter()` before and `on_exit(out)` after; with
    ``on_stage`` set, passes it to `real` as its ``on_stage`` argument."""

    def __init__(self, real):
        self.real = real
        self.on_enter = self.on_exit = self.on_stage = None

    def __call__(self, *args, **kw):
        if self.on_enter:
            self.on_enter()
        if self.on_stage is not None:
            kw["on_stage"] = self.on_stage
        out = self.real(*args, **kw)
        if self.on_exit:
            self.on_exit(out)
        return out


class Marks:
    """Host marks: mark(name) says the host has just finished stage
    `name`; the stage at a time is the one the next mark ends."""

    def __init__(self):
        self.t: list[int] = []
        self.names: list[str] = []

    def __call__(self, name: str, *_):
        self.t.append(time.time_ns())
        self.names.append(name)

    def stage_at(self, t_ns: int) -> str:
        i = bisect.bisect_left(self.t, t_ns)
        return self.names[i] if i < len(self.names) else "after"


def _short(name: str) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= 96 else name[:93] + "..."


def device_window(fn, sync, marks: Marks | None = None) -> tuple:
    """fn() under the profiler: → (fn's result, reduction).  The
    reduction holds the window's host seconds, the device's busy seconds
    (the union of every device event), kernel launches (device events
    that are not copies or memsets), seconds and launches by kernel name,
    and idle seconds by host stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.time_ns()
        out = fn()
        sync()
        t1 = time.time_ns()
    evs = [(ev.start_ns(), ev.duration_ns(), ev.name())
           for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == cuda]
    return out, reduce_events(evs, t0, t1, marks)


def reduce_events(evs: list, t0: int, t1: int, marks: Marks | None) -> dict:
    """Device events (start ns, duration ns, name) of a window [t0, t1]
    of the host's clock → the reduction ``device_window`` returns."""
    evs = sorted(evs)
    by_name: dict = {}
    launches = 0
    for _, dur, name in evs:
        acc = by_name.setdefault(name, [0, 0])
        acc[0] += 1
        acc[1] += dur
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
    # the busy union, and the gaps between busy stretches
    busy, gaps = 0, []
    cur_s = cur_e = None
    for start, dur, _ in evs:
        end = start + dur
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, start - cur_e))
            else:
                gaps.append((t0, max(start - t0, 0)))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, max(t1 - cur_e, 0)))
    # the device's clock is the host's when every event lies in [t0, t1]
    aligned = bool(evs) and evs[0][0] >= t0 and evs[-1][0] <= t1
    idle: dict = {}
    for start, dur in gaps:
        stage = (marks.stage_at(start) if marks and aligned else
                 "unaligned clock" if marks else "idle")
        idle[stage] = idle.get(stage, 0) + dur
    return dict(
        window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9, launches=launches,
        by_name={k: [v[0], v[1] / 1e9] for k, v in by_name.items()},
        idle_by_stage={k: v / 1e9 for k, v in idle.items()},
        clock_aligned=aligned)


def breakdown(red: dict) -> dict:
    """The ten device operations that took most time and the ten host
    stages with the most idle device time."""
    ops = sorted(red["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(red["idle_by_stage"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[_short(k), v[1]] for k, v in ops],
                idle_gaps=[[k, v] for k, v in idle])
