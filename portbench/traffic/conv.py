"""Hybrid HE/MPC conv requests, one client in a closed loop: the conv + BN
of each of the model's plain-stride layers in graph order, cycling, on
the plain model's activations of `inputs_per_layer` seeded inputs; each
request runs from its ciphertext in host memory to the output
ciphertext back in host memory.  Every request's output is checked
after the window."""

from __future__ import annotations

import time

import numpy as np
from optimal_conv_tpu_torch.ops import conv as convops

from portbench import load
from portbench import trace as tr

PARAMS = ("inputs_per_layer",)


class Entry(load.Entry):
    """Set-up encrypts the client's inputs; request i runs layer
    L[i mod |L|] on input (i div |L|) mod K of that layer."""

    def setup(self) -> None:
        m, k = self.model, self.traffic["inputs_per_layer"]
        self.lis = m.conv_layers()
        self.refs = [m.reference(m.image(j)) for j in range(k)]
        self.inputs = {}
        for j in range(k):
            x = m.image(j)
            for li in self.lis:
                ct = m.encrypt_features(
                    m.conv_input(li, x, self.refs[j][1]), m.conv_block(li))
                self.inputs[li, j] = load.to_host(ct)
        self.done: list = []           # (layer, input, host ciphertext)
        for i in range(len(self.lis)):
            self.request(i)
        self.done.clear()

    def request(self, i: int) -> None:
        """One request: its ciphertext from host memory to the card, the
        conv, the output back in host memory."""
        m = self.model
        li = self.lis[i % len(self.lis)]
        j = (i // len(self.lis)) % len(self.refs)
        out = m.conv(load.to_card(self.inputs[li, j], m.device), li)
        self.done.append((li, j, load.to_host(out)))

    def window(self, seconds: float) -> dict:
        _, spans = load.closed_loop(seconds, self.request)
        lat = np.array([(b - a) * 1e3 for a, b in spans])
        return dict(conv_ms_p95=float(np.percentile(lat, 95)))

    def traced(self) -> dict:
        """One pass over the layers with a span around the kernel
        encoding (``prep_ker``), then one under the profiler with host
        marks."""
        sync, n = self.sync, len(self.lis)
        tap = tr.Tap(convops.prep_ker)
        convops.prep_ker = tap
        enc = []
        try:
            def enter():
                sync()
                enc.append(time.perf_counter())

            def leave(_):
                sync()
                enc[-1] = time.perf_counter() - enc[-1]
            tap.on_enter, tap.on_exit = enter, leave
            for i in range(n):
                self.request(i)
            counters = load.KernelCounters()
            marks = tr.Marks()
            tap.on_enter, tap.on_exit = (lambda: marks("upload"),
                                         lambda _: marks("encode"))

            def cycle():
                for i in range(n, 2 * n):
                    marks("client")
                    self.request(i)
                    marks("conv")
            _, red = tr.device_window(cycle, sync, marks)
        finally:
            convops.prep_ker = tap.real
        return dict(kind="conv", encode_s=enc, profile=red,
                    counters=counters.delta(), requests=n)

    def check(self, limits: dict) -> tuple:
        """After the window: decrypt every request's output, free the
        program's state, hold each to the reference's conv + BN."""
        m = self.model
        got = [(li, j, m.unpack(load.to_card(h, m.device), m.conv_block(li),
                                m.calls[li][3]))
               for li, j, h in self.done]
        m.free()
        gaps = [load.gap(g, self.refs[j][0][li], 2.0 ** m.pows[li])
                for li, j, g in got]
        failed = sum(g > limits["conv_gap"] for g in gaps)
        return dict(conv_gap=max(gaps)), len(gaps), failed
