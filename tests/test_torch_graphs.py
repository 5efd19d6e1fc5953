"""The CUDA graphs of the bootstrapper's polynomial evaluations
(``ckks/graphs.py``), on the CPU: the cached constant column that capture
needs, the keys, which contexts stay eager, and the bookkeeping of a
capture and its replays (a stand-in graph; the card tests in
``tests/test_torch_cuda.py`` capture real ones)."""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks import bootstrap as btpmod
from optimal_conv_tpu_torch.ckks import graphs
from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import mini_boot_params, tiny_params
from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.core import modmath as mm
from optimal_conv_tpu_torch.core.cuda_lib import KernelStats
from optimal_conv_tpu_torch.ops.relu import relu_key
from optimal_conv_tpu_torch.parallel.coeffs import CoeffShardedContext
from optimal_conv_tpu_torch.parallel.limbs import LimbShardedContext
from optimal_conv_tpu_torch.parallel.sharding import build_mesh
from optimal_conv_tpu_torch.utils import tracing


@pytest.fixture(scope="module")
def tiny():
    p = tiny_params(9, 3)
    ctx = CkksContext(p, "cpu", seed=3)
    x = np.random.default_rng(3).uniform(-1, 1, p.slots)
    return ctx, ctx.encrypt(ctx.encoder.encode_slots(x, p.scale, 3))


def _moved(before: dict, name: str) -> int:
    return tracing.counters().get(name, 0) - before.get(name, 0)


def test_add_const_caches_its_column(tiny, monkeypatch):
    """A second add_const of the same constant at the same level makes no
    tensor: the column comes from the cache, and the sums are equal."""
    ctx, ct = tiny
    made = []
    col = ctx._const_col
    monkeypatch.setattr(ctx, "_const_col",
                        lambda c, lvl: made.append(c) or col(c, lvl))
    first = ctx.add_const(ct, 0.3125)
    second = ctx.add_const(ct, 0.3125)
    assert len(made) == 1
    assert torch.equal(first.c0, second.c0) and second.c1 is ct.c1
    ctx.add_const(ct, -0.3125)
    assert len(made) == 2


@pytest.mark.parametrize("const", [0.71, -0.71, 0.0],
                         ids=["positive", "negative", "zero"])
def test_add_const_column_is_the_constant_mod_each_prime(tiny, const):
    """The cached column holds round(c·scale) mod q_i on every modulus of
    every level, as ``_const_col`` builds it, and add_const adds it."""
    ctx, ct = tiny
    p = ctx.params
    for lvl in range(ct.level + 1):
        at = ctx.drop_level(ct, ct.level - lvl)
        out = ctx.add_const(at, const)
        c = int(round(const * at.scale))
        col = ctx._pt_cache[("add", c, lvl)]
        want = np.array([c % p.moduli[i] for i in range(lvl + 1)])[:, None]
        assert np.array_equal(col.numpy(), want)
        assert torch.equal(col, ctx._const_col(c, lvl))
        assert torch.equal(out.c0, mm.add_mod(at.c0, col, ctx._q(lvl)))


class _CudaLooking:
    """A tensor that says it is on the card."""
    is_cuda = True


@pytest.mark.parametrize("kind", ["cpu", "limbs", "coeffs"])
def test_cpu_and_sharded_contexts_stay_eager(tiny, kind, monkeypatch):
    """CPU tensors, and any tensor on a sharded context, run the body
    eagerly, count ``graph.eager`` and never capture."""
    def no_graph(*a, **kw):
        raise AssertionError("captured")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    ctx, ct = tiny
    if kind == "limbs":
        ctx = LimbShardedContext(ctx.params, "cpu", build_mesh((1, 1)), seed=3)
    elif kind == "coeffs":
        ctx = CoeffShardedContext(ctx.params, "cpu", build_mesh((1, 1)), seed=3)
    if kind != "cpu":
        assert not ctx._graphs.enabled
        ct = Ciphertext(_CudaLooking(), _CudaLooking(), level=3, scale=1.0)
    before = tracing.counters()
    for _ in range(2):
        assert ctx._graphs.run(("k",), ct, lambda c: "eager") == "eager"
    assert _moved(before, "graph.eager") == 2
    assert _moved(before, "graph.captures") == 0
    assert not ctx._graphs.graphs


def test_graph_keys():
    """ReLU keys differ by scale and by shape; the two halves of a
    full-slot layer meet EvalMod, and then the ReLU, with equal keys."""
    p = mini_boot_params(9)
    ctx = CkksContext(p, "cpu", seed=5)
    btp = SplitBootstrapper(ctx, log_sparse=0, k_range=12.0, sin_deg=7,
                            double_angle=2)
    x = np.random.default_rng(5).uniform(-0.5, 0.5, p.slots)
    ct = ctx.encrypt(ctx.encoder.encode_slots(x, btp.delta_m,
                                              btp.post_ctos_level))
    cj = ctx.conjugate(ct)                    # as ``ctos`` splits the halves
    up, low = ctx.add(ct, cj), ctx.div_by_i(ctx.sub(ct, cj))
    assert btp.eval_mod_key(up) == btp.eval_mod_key(low)
    up, low = btp._eval_mod(up), btp._eval_mod(low)
    assert relu_key(up, 0.0, None) == relu_key(low, 0.0, None)
    other = up.with_scale(up.scale * (1 + 2.0 ** -40))
    assert relu_key(other, 0.0, None) != relu_key(up, 0.0, None)
    wide = Ciphertext(up.c0[None], up.c1[None], level=up.level, scale=up.scale)
    assert relu_key(wide, 0.0, None) != relu_key(up, 0.0, None)
    assert relu_key(up, 0.1, None) != relu_key(up, 0.0, None)


class _FakeGraph:
    """A graph that replays by running the captured step again."""
    replays = 0
    step = None

    def replay(self):
        self.replays += 1
        if self.step:
            self.step()


def test_take_back_and_replay_credit_kernel_stats():
    """The launches a capture counted are taken back, and every replay
    credits them again, by rows, with no span tally."""
    stats = KernelStats("graph_test_kernel")
    stats.launched(4)
    before = graphs._kernel_counts()
    stats.launched(4)
    stats.launched(7)
    moved = [m for m in graphs._take_back(before) if m[0] is stats]
    assert moved == [(stats, 2, {4: 1, 7: 1})]
    assert stats.launches == 1 and stats.by_rows == {4: 1}
    ins = (torch.zeros(2, 5, dtype=torch.int64),
           torch.zeros(2, 5, dtype=torch.int64))
    g = graphs.Graph(_FakeGraph(), ins, ins, 1, 2.0, moved, [])
    src = Ciphertext(torch.arange(10).view(2, 5), torch.ones(2, 5,
                     dtype=torch.int64), level=1, scale=2.0)
    with tracing.collect(), tracing.span("replayed") as sp:
        for _ in range(2):
            out = g.replay(src)
    assert g.graph.replays == 2
    assert stats.launches == 5 and stats.by_rows == {4: 3, 7: 2}
    assert "graph_test_kernel" not in sp.kernels
    assert torch.equal(out.c0, src.c0) and torch.equal(out.c1, src.c1)
    assert out.c0.data_ptr() != ins[0].data_ptr()      # a copy of the output


def test_first_call_captures_later_calls_replay(tiny, monkeypatch):
    """run's bookkeeping with a stand-in graph: the first call of a key
    runs eagerly and captures (holding the keys its body reads, taking
    back the capture's launches), later calls replay, and an owner's
    graphs go with ``drop``."""
    def record(graph, pool, step):
        graph.step = step
        return step()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    ctx, ct = tiny
    cache = graphs.GraphCache(True)
    cache.serves = lambda c: True
    monkeypatch.setattr(ctx, "_graphs", cache)
    stats = KernelStats("graph_test_body")

    def body(c):
        stats.launched(c.c0.shape[-2])
        return ctx.rescale(ctx.mul_ct(c, c))

    owner = object.__new__(SplitBootstrapper)
    before = tracing.counters()
    first = cache.run(("sq",), ct, body, owner=owner)
    want = body(ct)
    assert torch.equal(first.c0, want.c0) and torch.equal(first.c1, want.c1)
    assert (first.level, first.scale) == (want.level, want.scale)
    (key, g), = cache.graphs.items()
    assert key == (id(owner), "sq")
    assert any(swk is ctx.relin_key(ct.level) for swk, _ in g.held)
    assert g.launches == [(stats, 1, {4: 1})]
    # eager, capture (taken back), the first replay, `want`: the replays'
    # own launches, and the credit of each
    assert stats.launches == 4
    other = ctx.add_const(ct, 0.5)
    again = cache.run(("sq",), other, body, owner=owner)
    want = body(other)
    assert torch.equal(again.c0, want.c0) and torch.equal(again.c1, want.c1)
    assert g.graph.replays == 2 and stats.launches == 7
    assert _moved(before, "graph.eager") == 1
    assert _moved(before, "graph.captures") == 1
    assert _moved(before, "graph.replays") == 1
    cache.drop(owner)
    assert not cache.graphs


def test_a_starved_key_cache_keeps_the_call_eager(tiny, monkeypatch):
    """Where the key cache cannot hold the keys of one call, the first
    call's eager run sees a key it read evicted: the call is never
    captured (a capture would make that key again inside the graph), and
    its later calls run eagerly.  With room for the keys it captures."""
    def record(graph, pool, step):
        graph.step = step
        return step()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _, ct = tiny
    p = tiny_params(9, 3)
    starved = CkksContext(p, "cpu", seed=3, key_cache_gib=1e-9,
                          key_expand_gib=0.0)
    roomy = CkksContext(p, "cpu", seed=3)

    def body_of(ctx):
        # two keys: relinearisation, then a rotation's
        return lambda c: ctx.rotate(ctx.rescale(ctx.mul_ct(c, c)), 1)

    for ctx, captured in ((starved, False), (roomy, True)):
        cache = graphs.GraphCache(True, ctx._swk_cache)
        cache.serves = lambda c: True
        monkeypatch.setattr(ctx, "_graphs", cache)
        body = body_of(ctx)
        before = tracing.counters()
        for _ in range(2):
            got = cache.run(("sq_rot",), ct, body)
            want = body(ct)
            assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
        assert bool(cache.graphs) == captured
        assert (("sq_rot",) in cache.eager) != captured
        assert _moved(before, "graph.captures") == int(captured)
        assert _moved(before, "graph.eager") == (1 if captured else 2)
    assert starved._swk_cache._evict_n > 0 and roomy._swk_cache._evict_n == 0


def test_family_eviction_drops_graphs(tiny, monkeypatch):
    """A bootstrapper the family evicts takes its graphs with it."""
    class Stub:
        def __init__(self, ctx, log_sparse, **kw):
            self.ls = log_sparse
    monkeypatch.setattr(btpmod, "SplitBootstrapper", Stub)
    ctx, _ = tiny
    cache = graphs.GraphCache(True)
    monkeypatch.setattr(ctx, "_graphs", cache)
    fam = btpmod.BootstrapperFamily(ctx, max_live=1)
    b0 = fam[0]
    cache.graphs[(id(b0), "evalmod")] = "graph of 0"
    cache.graphs[("relu",)] = "graph of the ReLU"
    fam[1]
    assert 0 not in fam
    assert list(cache.graphs) == [("relu",)]
