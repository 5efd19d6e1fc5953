"""The general traffic generator: reads a traffic mix's data file
(``portbench/traffic/<mix>.json``) and drives the entry it names
(``portbench/traffic/<entry>.py``).

An entry module holds the seeded requests of its kind and the loop that
drives them: a class ``Entry`` (set-up that warms every shape it will
use, the measured window, the traced pass, and the check after the
window of what the timed path produced against the plain reference) and
``PARAMS``, the mix's keys it reads beside "entry" and "why".  A mix
that sets another key is refused, so no parameter is silently ignored.
A new kind of traffic is a new entry module; a new mix of a kind is a
new data file."""

from __future__ import annotations

import importlib
import re
import time

import numpy as np
import torch
from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.core import (d1_kernel, mont_kernel, mxu_kernel,
                                         ntt_kernel)

NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def entry(model, traffic: dict, sync):
    """The entry that `traffic` names, made for `model`."""
    name = traffic.get("entry", "")
    if not NAME.match(name):
        raise SystemExit(f"traffic entry {name!r} is no module name")
    mod = importlib.import_module(f"portbench.traffic.{name}")
    unknown = set(traffic) - {"entry", "why"} - set(mod.PARAMS)
    if unknown:
        raise SystemExit(f"traffic entry {name!r} reads no "
                         f"{', '.join(sorted(unknown))}")
    return mod.Entry(model, traffic, sync)


class Entry:
    def __init__(self, model, traffic: dict, sync):
        self.model, self.traffic, self.sync = model, traffic, sync


def closed_loop(seconds: float, one) -> tuple:
    """One client: one(i) for i = 0, 1, ... while the window is open; a
    request started inside it is finished and counted.
    → (start, [(t0, t1)])."""
    start = time.perf_counter()
    end, spans, i = start + seconds, [], 0
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            return start, spans
        one(i)
        spans.append((t0, time.perf_counter()))
        i += 1


def gap(got, want, unit: float) -> float:
    """The widest gap between a program's output and the reference's, in
    units of `unit`; inf where the output is missing or not finite."""
    got = np.asarray(got, dtype=np.float64)
    if got.shape != np.shape(want) or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max() / unit)


def to_host(ct: Ciphertext, wait: bool = True) -> tuple:
    """A ciphertext copied to host memory: (c0, c1, level, scale).  With
    wait False the copy is queued behind the device's work (into pinned
    memory from a card) and the host goes on; it is complete once the
    device is synchronised."""
    def copy(t):
        pin = t.is_cuda and not wait
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        return out.copy_(t, non_blocking=pin)
    return copy(ct.c0), copy(ct.c1), ct.level, ct.scale


def to_card(host: tuple, device) -> Ciphertext:
    c0, c1, level, scale = host
    return Ciphertext(c0.to(device), c1.to(device), level, scale)


class KernelCounters:
    """The program's kernel counters (``core/*_kernel.py``): rows by call
    of each kernel since this object was made."""

    def __init__(self):
        self.stats = [mont_kernel.STATS, ntt_kernel.STATS_FWD,
                      ntt_kernel.STATS_INV, ntt_kernel.STATS_CROSS,
                      mxu_kernel.STATS_FWD, mxu_kernel.STATS_INV,
                      d1_kernel.STATS]
        self.base = {s.name: dict(s.by_rows) for s in self.stats}

    def delta(self) -> dict:
        out = {}
        for s in self.stats:
            d = {r: c - self.base[s.name].get(r, 0)
                 for r, c in s.by_rows.items()}
            out[s.name] = {r: c for r, c in d.items() if c}
        return out
