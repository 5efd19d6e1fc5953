"""CUDA graphs of the bootstrapper's two polynomial evaluations.

EvalMod (``SplitBootstrapper._eval_mod``) and the minimax ReLU
(``ops/relu.eval_relu``) are chains of many small launches: NTTs, basis
extensions, Montgomery products and elementwise adds, a relinearisation
and a rescale after every product.  Issued one by one from Python, their
host time, not their device time, sets the pace of an image.  A
``GraphCache`` (a context's ``_graphs``) captures such a call as a CUDA
graph the first time it meets the call's key, and replays the graph at
every later call with that key.

The key holds everything that decides the Python control flow and the
integer constants baked into the captured launches; the caller reads it
from its input (the level and shape, and the scale where the body reads
it).  The first call with a key runs eagerly, which makes every key,
table and constant column the chain reads; then the same body is
captured on a copy of the input and replayed once, and that replay must
equal the eager result residue for residue, or ``run`` raises.  A later
call copies its input into the graph's static input, replays, and
returns a copy of the output.

Memory.  All graphs of a context allocate from one private pool, and
all read their input from one buffer of the context, sized to the
largest input.  A body's last launches copy its output over its input's
place in that buffer, so no graph keeps anything in the pool between
replays: replays in any order are safe while each output is copied out
before the next replay, which ``run`` does.  What stays allocated is the
buffer; the pool keeps one capture's working set as reserved memory.

A graph reads the switching keys of its capture by address, so its
record holds them: ``CkksContext.swk_d1`` hands each key it serves to
``hold``, which keeps it while a capture runs.  An eviction by the key
cache then cannot free memory a graph still reads.  A capture may not
make a key: a key made there would live in the graphs' pool, and its
upload of host tables cannot be captured.  So the first call's eager
run notes the keys it reads, and where the key cache no longer holds
one of them at its end (a cache too small for the keys of one call),
the call's key is never captured: its calls stay eager.  Graphs run where the
ciphertext is a CUDA tensor and the context's class allows them
(``CkksContext.GRAPHS``; the sharded contexts run collectives and stay
eager).

Counters (``utils/tracing.py``): ``graph.captures``, ``graph.replays``,
and ``graph.eager``, the calls no graph served (CPU tensors, a sharded
context, a key's first call).  A replay runs no kernel wrapper, so it
credits each ``KernelStats`` with the launches and rows its capture
recorded; the capture's own counts, of launches that ran nowhere, are
taken back.
"""

from __future__ import annotations

import collections
import weakref

import torch

from ..utils import tracing
from .types import Ciphertext


class Graph:
    """One captured call: the graph, the views of the buffer it reads
    (`ins`) and writes (`outs`), the output's level and scale, the
    kernel counts a replay credits ([(KernelStats, launches, rows by
    call)]) and the keys it reads."""

    __slots__ = ("graph", "ins", "outs", "level", "scale", "launches",
                 "held")

    def __init__(self, graph, ins, outs, level, scale, launches, held):
        self.graph, self.ins, self.outs = graph, ins, outs
        self.level, self.scale = level, scale
        self.launches, self.held = launches, held

    def replay(self, ct: Ciphertext) -> Ciphertext:
        for view, t in zip(self.ins, (ct.c0, ct.c1)):
            view.copy_(t)
        self.graph.replay()
        for stats, n, rows in self.launches:
            stats.credit(n, rows)
        return Ciphertext(self.outs[0].clone(), self.outs[1].clone(),
                          level=self.level, scale=self.scale)


class GraphCache:
    """{key: Graph} of one context; `enabled` is the context's
    ``GRAPHS``."""

    def __init__(self, enabled: bool, keys=None):
        self.enabled = enabled
        self.keys = keys                     # the context's key cache
        self.graphs: dict = {}
        self.eager: set = set()              # keys whose calls stay eager
        self.pool = None
        self.buf: torch.Tensor | None = None
        self._held: list | None = None       # the keys read, while capturing
        self._seen: list | None = None       # weakly, in a first eager run
        self._owners: dict = {}              # id → finalizer of an owner

    def hold(self, swk, d1) -> None:
        """A switching key and its d1 served while a capture runs are kept
        by the graph; one served in a first call's eager run is noted by a
        weak reference, which keeps nothing the key cache drops."""
        if self._held is not None:
            self._held.append((swk, d1))
        if self._seen is not None:
            self._seen.append(weakref.ref(swk))

    def serves(self, ct: Ciphertext) -> bool:
        """Whether graphs serve calls on ct: a CUDA tensor, and a context
        that allows them."""
        return self.enabled and ct.c0.is_cuda

    def run(self, key: tuple, ct: Ciphertext, body, owner=None) -> Ciphertext:
        """body(ct), from the graph of `key` where one serves it.  An
        `owner` (a bootstrapper) is part of the key, and its graphs go
        when it does (``drop``)."""
        if not self.serves(ct):
            tracing.count("graph.eager")
            return body(ct)
        if owner is not None:
            key = (id(owner),) + key
        g = self.graphs.get(key)
        if g is not None:
            tracing.count("graph.replays")
            return g.replay(ct)
        tracing.count("graph.eager")
        if key in self.eager:
            return body(ct)
        self._seen = []
        try:
            want = body(ct)
        finally:
            seen, self._seen = self._seen, None
        if self.keys is not None and not all(
                ref() is not None and self.keys.holds(ref()) for ref in seen):
            # the keys of one call do not fit the key cache: a capture
            # would make keys again
            self.eager.add(key)
            self._owned_by(owner)
            return want
        g = self._capture(ct, body, want)
        got = g.replay(ct)
        if ((got.level, got.scale) != (want.level, want.scale)
                or not torch.equal(got.c0, want.c0)
                or not torch.equal(got.c1, want.c1)):
            raise RuntimeError(f"the CUDA graph of {key} does not replay its "
                               "eager result")
        tracing.count("graph.captures")
        self.graphs[key] = g
        self._owned_by(owner)
        return got

    def _owned_by(self, owner) -> None:
        """The keys of `owner` go when it does."""
        if owner is not None and id(owner) not in self._owners:
            self._owners[id(owner)] = weakref.finalize(owner, self._drop_id,
                                                       id(owner))

    def drop(self, owner) -> None:
        """Drop the graphs of `owner`."""
        fin = self._owners.get(id(owner))
        if fin is not None:
            fin.detach()
        self._drop_id(id(owner))

    def _drop_id(self, oid: int) -> None:
        self._owners.pop(oid, None)
        for key in [k for k in self.graphs if k[0] == oid]:
            del self.graphs[key]
        self.eager = {k for k in self.eager if k[0] != oid}

    def _capture(self, ct: Ciphertext, body, want: Ciphertext) -> Graph:
        """Capture body on views of the buffer shaped as ct; its output is
        copied over the input's place.  Capture runs nothing: the replay
        fills the input."""
        need = max(ct.c0.numel() + ct.c1.numel(),
                   want.c0.numel() + want.c1.numel())
        if self.buf is None or self.buf.numel() < need:
            # graphs captured on a smaller buffer keep it through their views
            self.buf = torch.empty(need, dtype=torch.int64,
                                   device=ct.c0.device)
        ins = _views(self.buf, ct.c0.shape, ct.c1.shape)
        outs = _views(self.buf, want.c0.shape, want.c1.shape)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        base = self.buf.untyped_storage().data_ptr()

        def step():
            out = body(Ciphertext(ins[0], ins[1], level=ct.level,
                                  scale=ct.scale))
            if any(t.untyped_storage().data_ptr() == base
                   for t in (out.c0, out.c1)):
                raise ValueError("a graph's body returned a view of its input")
            for view, t in zip(outs, (out.c0, out.c1)):
                view.copy_(t)
            return out.level, out.scale

        graph = torch.cuda.CUDAGraph()
        before = _kernel_counts()
        held = self._held = []
        try:
            level, scale = _record(graph, self.pool, step)
        finally:
            self._held = None
            launches = _take_back(before)
        return Graph(graph, ins, outs, level, scale, launches, held)


def _record(graph, pool, step):
    """step() captured into `graph`, its allocations from `pool`."""
    with torch.cuda.graph(graph, pool=pool):
        return step()


def _views(buf: torch.Tensor, s0, s1) -> tuple:
    """Two tensors of shapes s0 and s1 laid one after the other from the
    start of buf."""
    n0, n1 = s0.numel(), s1.numel()
    return buf[:n0].view(s0), buf[n0:n0 + n1].view(s1)


def _kernel_counts() -> list:
    return [(s, s.launches, collections.Counter(s.by_rows))
            for s in tracing.kernel_stats()]


def _take_back(before: list) -> list:
    """Restore each ``KernelStats`` to its counts in `before` (from
    ``_kernel_counts``) → what each counted since, where it moved:
    [(stats, launches, rows by call)]."""
    moved = []
    for s, n, rows in before:
        if s.launches != n:
            moved.append((s, s.launches - n, s.by_rows - rows))
            s.launches, s.by_rows = n, rows
    return moved
