"""Spans and counters of the port, on the profiler's clock.

A span is a named stretch of host time.  Spans are recorded only while
``recording()`` is true: inside ``with collect():``, or while a
``torch.profiler`` session is enabled (the NVTX model: a range costs one
flag check unless a profiler listens).  Otherwise a span site, an
evaluator call and a kernel wrapper's launch each cost that check and
nothing more: no allocation, no clock read.

Times are ``time.time_ns()``, the clock the profiler's device events are
matched to, so the device work of a span can be found by its interval.
Each closed span becomes one record, a dict:

    name      the span's name
    id        its id; parent: the enclosing span's id (0 for a root);
    root      the root's id (every span of one request shares it)
    t0, t1    start and end, ``time.time_ns()``
    attrs     a few attributes (a layer's kind and log_sparse, ...)
    seq       its ordinal among the spans of its name in its root (the
              index of a layer in its image)
    eval      [calls, ns]: the outermost ``CkksContext`` evaluator calls
              made while it was the innermost open span, and their host
              time
    kernels   {kernel: [calls, ns, rows]}: the hand-kernel wrapper calls
              made likewise, each timed from the wrapper's entry to its
              launch
    counters  (roots only) the counters that moved while it was open

The tallies are sums, not records, so the 10^4 - 10^5 evaluator and
wrapper calls of an image add none.  The newest ``CAPACITY`` records are
kept in memory; ``records()`` and ``clear()`` read and reset them.

Counters are always on: ``count(name, n)`` is a plain add at a rare
event.  ``counters()`` reads them, the gauges (``gauge``), and every
``KernelStats`` of ``core/cuda_lib.py`` (``kernel.<name>.launches``,
``.rows``, ``.plain_calls``), which register here.  The port's
counters: ``keys.*`` (``ckks/context.py``), ``boot.builds`` /
``boot.build_s`` (``ckks/bootstrap.py``), ``encode.bytes_up``
(``ckks/encoding.py``: pageable bytes uploaded to encode) and, beside
it, ``encode.kernel.pts`` / ``encode.kernel.host_pts``
(``ops/conv.prep_ker``: kernel plaintexts made by the batched pass on the
device / one at a time on the host), ``conv.pack.keyswitches``
(``ops/conv._conv_pack``: the key-switch rows of the conv's pack, C − 1
a conv of C plaintexts), ``repack.rotations``
(``ops/pipeline._masked_rotate_sum``: the rotations of the masked
rotate-sum repacks, each stage of a two-stage one), ``graph.captures`` /
``graph.replays`` / ``graph.eager`` (``ckks/graphs.py``: the
bootstrapper's polynomial evaluations captured, replayed, or run with no
graph).  The recorder serves one thread: the port drives a card from
one.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import time

import torch

CAPACITY = 65536

_records: collections.deque = collections.deque(maxlen=CAPACITY)
_open: list = []                 # the open spans, innermost last
_ids = itertools.count(1)
_collecting = 0                  # depth of open ``collect()`` blocks
_depth = 0                       # 1 inside a timed evaluator call
_profiling = torch._C._autograd._profiler_enabled
_now = time.time_ns
_ns = time.perf_counter_ns

_counts: collections.Counter = collections.Counter()
_gauges: dict = {}
_stats: list = []                # KernelStats, in the order made


def recording() -> bool:
    """True inside ``collect()`` and while a torch profiler is enabled."""
    return bool(_collecting) or _profiling()


@contextlib.contextmanager
def collect():
    """Record spans inside the block, with or without a profiler."""
    global _collecting
    _collecting += 1
    try:
        yield
    finally:
        _collecting -= 1


def records() -> list:
    """The kept records, oldest first (a span is kept when it closes)."""
    return list(_records)


def clear() -> None:
    _records.clear()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _Span:
    __slots__ = ("name", "id", "parent", "root", "t0", "attrs", "eval",
                 "kernels", "seqs", "base")

    def __init__(self, name, attrs):
        parent = _open[-1] if _open else None
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.eval = [0, 0]
        self.kernels = {}
        if parent is None:
            self.parent, self.root = 0, self
            self.seqs = collections.Counter()
            self.base = dict(_counts)
        else:
            self.parent, self.root = parent.id, parent.root
        _open.append(self)
        self.t0 = _now()

    def close(self, name=None) -> None:
        """End the span (named `name` if given) and keep its record;
        spans left open inside it are folded into it first."""
        t1 = _now()
        _unwind(self)
        _open.pop()
        name = self.name if name is None else name
        root = self.root
        rec = dict(name=name, id=self.id, parent=self.parent, root=root.id,
                   t0=self.t0, t1=t1, attrs=self.attrs or {},
                   seq=root.seqs[name], eval=self.eval, kernels=self.kernels)
        root.seqs[name] += 1
        if root is self:
            rec["counters"] = {k: v - self.base.get(k, 0)
                               for k, v in _counts.items()
                               if v != self.base.get(k, 0)}
        _records.append(rec)

    def drop(self) -> None:
        """End the span without a record; its tallies go to its parent."""
        _unwind(self)
        _open.pop()
        if _open:
            _fold(self, _open[-1])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fold(child: _Span, into: _Span) -> None:
    into.eval[0] += child.eval[0]
    into.eval[1] += child.eval[1]
    for k, v in child.kernels.items():
        acc = into.kernels.setdefault(k, [0, 0, 0])
        for i in range(3):
            acc[i] += v[i]


def _unwind(span: _Span) -> None:
    """Drop the spans an exception left open above `span`."""
    while _open and _open[-1] is not span:
        _open[-1].drop()
    if not _open:
        raise RuntimeError(f"span {span.name!r} is not open")


_NULL = contextlib.nullcontext()


def span(name: str, **attrs):
    """``with span(name, **attrs):`` records the block while recording;
    otherwise it is a shared no-op context."""
    if _collecting or _profiling():
        return _Span(name, attrs)
    return _NULL


def spanned(name: str):
    """Decorator: the function's calls are spans `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if _collecting or _profiling():
                with _Span(name, None):
                    return fn(*args, **kw)
            return fn(*args, **kw)
        return call
    return wrap


class stages:
    """Stage spans cut at marks.

    ``with stages(name, *hooks, **attrs) as mark:`` opens span `name`
    (none if `name` is None) and, inside it, a stage that ``mark(stage,
    value)`` ends and names: each stage runs from the previous mark (or
    the block's start) to its own.  Then mark calls each hook that is
    not None as ``hook(stage, value)``, recording or not.  The stretch
    after the last mark is no stage; its tallies go to the enclosing
    span.  Nested blocks cut the stages of the stage they run in."""

    def __init__(self, name, *hooks, **attrs):
        self.name, self.attrs = name, attrs
        self.hooks = [h for h in hooks if h is not None]
        self.outer = self.cur = None

    def __enter__(self):
        if _collecting or _profiling():
            if self.name is not None:
                self.outer = _Span(self.name, self.attrs)
            self.cur = _Span(None, None)
        return self.mark

    def mark(self, name: str, value=None) -> None:
        if self.cur is not None:
            self.cur.close(name)
            self.cur = _Span(None, None)
        for hook in self.hooks:
            hook(name, value)

    def __exit__(self, *exc):
        if self.cur is not None:
            self.cur.drop()
        if self.outer is not None:
            self.outer.close()


# ---------------------------------------------------------------------------
# tallies: evaluator calls and kernel wrappers
# ---------------------------------------------------------------------------

def stamp() -> int:
    """``time.perf_counter_ns()`` while recording, else 0: a wrapper
    takes it at entry and hands it to ``KernelStats.launched``."""
    if _collecting or _profiling():
        return _ns()
    return 0


def kernel_call(kernel: str, rows: int, t0: int) -> None:
    """A hand-kernel wrapper call that began at `t0` (``stamp()``) has
    launched `rows` rows: tally it in the innermost open span."""
    if _open:
        acc = _open[-1].kernels.get(kernel)
        if acc is None:
            acc = _open[-1].kernels[kernel] = [0, 0, 0]
        acc[0] += 1
        acc[1] += _ns() - t0
        acc[2] += rows


def evaluator_op(fn):
    """Wrap an evaluator method: while recording, its outermost calls
    (a call inside another is not counted again) are tallied in the
    innermost open span."""
    @functools.wraps(fn)
    def op(*args, **kw):
        global _depth
        if _depth or not (_collecting or _profiling()):
            return fn(*args, **kw)
        _depth = 1
        t0 = _ns()
        try:
            return fn(*args, **kw)
        finally:
            _depth = 0
            if _open:
                e = _open[-1].eval
                e[0] += 1
                e[1] += _ns() - t0
    op.evaluator_op = True
    return op


def time_methods(cls, names) -> None:
    """Wrap the methods of `names` that `cls` itself defines with
    ``evaluator_op``."""
    for name in names:
        fn = cls.__dict__.get(name)
        if fn is not None and not getattr(fn, "evaluator_op", False):
            setattr(cls, name, evaluator_op(fn))


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def count(name: str, n=1) -> None:
    """Add n to counter `name` (always on)."""
    _counts[name] += n


def gauge(name: str, read) -> None:
    """Register read() as the value of `name` in ``counters()``."""
    _gauges[name] = read


def register(stats) -> None:
    """A ``KernelStats`` reports into ``counters()`` from now on."""
    _stats.append(stats)


def kernel_stats() -> list:
    """Every registered ``KernelStats``."""
    return list(_stats)


def counters() -> dict:
    """Every counter, gauge and kernel counter now."""
    out = dict(_counts)
    for name, read in _gauges.items():
        out[name] = read()
    for s in _stats:
        out[f"kernel.{s.name}.launches"] = s.launches
        out[f"kernel.{s.name}.rows"] = sum(r * c for r, c in s.by_rows.items())
        out[f"kernel.{s.name}.plain_calls"] = s.plain_calls
    return out


# ---------------------------------------------------------------------------
# reading records
# ---------------------------------------------------------------------------

def tree(recs: list, root_id: int) -> list:
    """The records of one root's spans, the root's own included."""
    return [r for r in recs if r["root"] == root_id]


def self_ns(recs: list) -> dict:
    """{id: ns of the span outside its children} over `recs`."""
    out = {r["id"]: r["t1"] - r["t0"] for r in recs}
    for r in recs:
        if r["parent"] in out:
            out[r["parent"]] -= r["t1"] - r["t0"]
    return out


def outermost(recs: list, names) -> list:
    """The records named in `names` with no ancestor so named."""
    names = set(names)
    by_id = {r["id"]: r for r in recs}

    def inside(r):
        p = by_id.get(r["parent"])
        while p is not None:
            if p["name"] in names:
                return True
            p = by_id.get(p["parent"])
        return False
    return [r for r in recs if r["name"] in names and not inside(r)]
