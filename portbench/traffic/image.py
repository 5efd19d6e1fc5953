"""Whole encrypted images, one client in a closed loop: input i of a run
from the seed through the model's ``infer`` (encrypt, every fused layer,
the head, decrypt).  Input 0 warms every shape; the window's images are
inputs 1, 2, ....  Every fused layer's output of every image is copied
to host memory as the timed path produces it, and checked after the
window with the image's logits."""

from __future__ import annotations

import time

from portbench import load
from portbench import trace as tr

PARAMS = ()


class Entry(load.Entry):

    def setup(self) -> None:
        m = self.model
        self.tap = tr.Tap(m.layer_module.eval_conv_bn_relu)
        self.tap.on_exit = self._keep
        m.layer_module.eval_conv_bn_relu = self.tap
        self.on_layer = None           # called at each layer's end first
        self.done: list = []           # (input, logits, kept layer outputs)
        self.infer(0)
        self.done.clear()

    def _keep(self, out) -> None:
        if self.on_layer:
            self.on_layer()
        self.kept.append(load.to_host(out, wait=False))

    def infer(self, i: int):
        m = self.model
        self.kept = []
        logits = m.infer(m.image(i))
        self.done.append((i, logits, self.kept))
        return logits

    def window(self, seconds: float) -> dict:
        start, spans = load.closed_loop(seconds, lambda i: self.infer(i + 1))
        return dict(image_s=(spans[-1][1] - start) / len(spans))

    def traced(self) -> dict:
        """One image with spans (each fused layer starts and ends in a
        synchronise, and the conv stage's end too), then one under the
        profiler with host marks at every stage."""
        sync, tap = self.sync, self.tap
        layers, convs = [], []

        def enter():
            sync()
            layers.append(time.perf_counter())

        def stage(name, _):
            if name == "conv":
                sync()
                convs.append(time.perf_counter() - layers[-1])

        def leave():
            sync()
            layers[-1] = time.perf_counter() - layers[-1]

        tap.on_enter, tap.on_stage, self.on_layer = enter, stage, leave
        sync()
        t0 = time.perf_counter()
        self.infer(1)
        image_s = time.perf_counter() - t0
        counters = load.KernelCounters()
        marks = tr.Marks()
        tap.on_enter, tap.on_stage, self.on_layer = (
            lambda: marks("runner"), marks, None)
        _, red = tr.device_window(
            lambda: (self.infer(2), marks("head")), sync, marks)
        tap.on_enter = tap.on_stage = None
        return dict(kind="image", image_s=image_s, layers_s=layers,
                    conv_s=convs, profile=red, counters=counters.delta())

    def check(self, limits: dict) -> tuple:
        """After the window: decrypt every image's kept layers, free the
        program's state, then hold each image's logits and all its kept
        layers to the plain reference.
        → (compared numbers, attempted, failed)."""
        m = self.model
        self.sync()
        got = [(i, logits, [m.unpack(load.to_card(h, m.device), blk, ch)
                            for h, (_, _, blk, ch) in zip(kept, m.calls)])
               for i, logits, kept in self.done]
        m.free()
        gaps = []
        for i, logits, outs in got:
            _, acts, ref = m.reference(m.image(i))
            g = load.gap(logits, ref, 2.0 ** m.logit_pow)
            for out, (li, sl, _, _) in zip(outs, m.calls):
                g = max(g, load.gap(out, acts[li][..., sl],
                                    2.0 ** m.pows[li]))
            if len(outs) != len(m.calls):
                g = float("inf")
            gaps.append(g)
        failed = sum(g > limits["gap"] for g in gaps)
        return dict(gap=max(gaps)), len(gaps), failed
