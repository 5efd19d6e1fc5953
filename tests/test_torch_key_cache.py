"""Seed-compressed switching keys and the key cache of the port (CPU).

* The plain d1 generator (``core/threefry.py``) against the JAX
  package's ``_uniform_mont_jax`` and ``_d1_regen_builder(...,
  with_perm=True)``, bit for bit, on two chains, at level 0 and the top
  level, at three seeds (one of them ≥ 2^32: only its low word counts).
  The JAX functions read only the parameters, so they run on a holder of
  the JAX chain and no JAX context is built.
* Every case of ``tests/test_key_cache.py`` against the port's
  ``_KeyCache`` and a compressed port context.
* The evaluator on compressed keys, and on a cache too small for its
  keys, equals the same context with every key stored whole, residue for
  residue.
* The cache's counters (hits, keys made, evictions, memos dropped, d1
  regenerated) against a hand count.

The JAX archives of compressed keys, both ways, are in
``tests/test_torch_interop.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini
from optimal_conv_tpu.ckks.params import tiny_params as jax_tiny
from optimal_conv_tpu.core.ntt import galois_perm_ntt as jax_perm

from optimal_conv_tpu_torch.ckks.context import (CkksContext, SwitchingKey,
                                                 _KeyCache)
from optimal_conv_tpu_torch.ckks.params import (DeviceTables, mini_boot_params,
                                                tiny_params)
from optimal_conv_tpu_torch.core import d1_kernel, threefry
from optimal_conv_tpu_torch.core import ntt as nttmod
from optimal_conv_tpu_torch.utils import tracing

CPU = torch.device("cpu")
torch.set_num_threads(1)

CHAINS = {"tiny_8_3": (lambda: jax_tiny(log_n=8, levels=3),
                       lambda: tiny_params(log_n=8, levels=3)),
          "mini_boot_9": (lambda: jax_mini(9), lambda: mini_boot_params(9))}
SEEDS = [5, (1 << 40) + 12345, 0xFFFFFFFF]


@pytest.fixture(scope="module")
def chains():
    """{name: (holder of the JAX chain, the port's tables)}, built once."""
    out = {}
    for name, (jax_p, port_p) in CHAINS.items():
        p = port_p()
        out[name] = (types.SimpleNamespace(params=jax_p()),
                     DeviceTables(p, CPU))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("top", [False, True], ids=["level0", "top"])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_uniform_mont_equals_jax(chains, chain, top, seed):
    holder, tables = chains[chain]
    p = tables.params
    level = p.max_level if top else 0
    qp = p.qp_idx(level)
    beta = len(p.digits(level))
    assert qp == holder.params.qp_idx(level)
    tabs = tables.ntt.tabs(qp)
    want = np.asarray(JaxContext._uniform_mont_jax(holder, seed, beta, qp))
    before = d1_kernel.STATS.plain_calls
    got = threefry.uniform_mont(seed, beta, *tabs, p.n)
    assert d1_kernel.STATS.plain_calls == before + 1
    assert d1_kernel.STATS.launches == 0
    assert got.shape == (beta, len(qp), p.n)
    assert np.array_equal(got.numpy().view(np.uint64), want)
    # the pre-permuted form, with the permutation of φ_g⁻¹ as "galh" keys
    # carry it
    g = pow(nttmod.rot_to_galois(3, p.log_n), -1, 2 * p.n)
    perm = jax_perm(p.log_n, g)
    regen = JaxContext._d1_regen_builder(holder, beta, qp, True)
    want_p = np.asarray(regen(jax.random.PRNGKey(seed & 0xFFFFFFFF),
                              jnp.asarray(perm)))
    got_p = threefry.uniform_mont(seed, beta, *tabs, p.n,
                                  torch.from_numpy(perm.astype(np.int64)))
    assert np.array_equal(got_p.numpy().view(np.uint64), want_p)
    assert torch.equal(got_p, got[..., torch.from_numpy(perm.astype(np.int64))])


def test_threefry_known_answer():
    """Threefry-2x32 (20 rounds) on the Random123 known-answer vector:
    key and counter all ones → (0x1cb996fc, 0xbb002be7)."""
    x0 = torch.tensor([0xFFFFFFFF], dtype=torch.int64)
    x1 = torch.tensor([0xFFFFFFFF], dtype=torch.int64)
    x0, x1 = threefry.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, x0, x1)
    assert (int(x0), int(x1)) == (0x1CB996FC, 0xBB002BE7)


def test_d1_regen_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: the dispatcher
    takes the plain version there, the wrapper raises."""
    tables = DeviceTables(tiny_params(log_n=8, levels=3), CPU)
    tabs = tables.ntt.tabs(tables.params.qp_idx(0))
    with pytest.raises(ValueError):
        d1_kernel.d1_regen_cuda(1, 1, *tabs, tables.params.n)


@pytest.mark.parametrize("rows, want", [(198, 8), (33, 8), (9, 2), (6, 1),
                                        (1, 1)])
def test_d1_regen_launch_plan(rows, want):
    """Rows a block of the d1_regen kernel draws at N = 2^16 on 132 SMs:
    8 for the large keys, fewer for a small key so that the grid keeps 16
    blocks an SM, and never a grid taller than 65535 blocks."""
    assert d1_kernel.rows_per_block(rows, 1 << 16, 132) == want
    rpb = d1_kernel.rows_per_block(rows * 100000, 128, 132)
    assert -(-rows * 100000 // rpb) <= 65535


# ---------------------------------------------------------------------------
# _KeyCache: the cases of tests/test_key_cache.py
# ---------------------------------------------------------------------------

def _mk(level=0, beta=2, n=16, compressed=True):
    d0 = torch.zeros((beta, 3, n), dtype=torch.int64)
    if compressed:
        return SwitchingKey(d0, None, level, seed=0)
    return SwitchingKey(d0, d0, level, seed=0)


SZ = 2 * 3 * 16 * 8          # d0 bytes of one _mk key (768)


def test_resident_tier_lru_eviction():
    c = _KeyCache(max_bytes=3 * SZ + 1, policy="lru")
    ks = [_mk() for _ in range(4)]
    for i, k in enumerate(ks[:3]):
        c.put(i, k)
    assert c.d0_bytes == 3 * SZ and set(c.d) == {0, 1, 2}
    c.get(0)                              # 0 becomes most-recent
    c.put(3, ks[3])                       # over budget -> evict LRU = 1
    assert set(c.d) == {0, 2, 3}
    assert c.d0_bytes == 3 * SZ
    # uncompressed keys charge d0+d1 (2x) and their eviction refunds 2x
    big = _mk(compressed=False)
    c.put(4, big)                         # 2*SZ -> evicts 0 then 2
    assert 4 in c.d and c.d0_bytes <= c.max_bytes


def test_resident_tier_mru_eviction_cyclic():
    """The default "mru" policy: under a cyclic scan whose working set
    exceeds the budget, the early keys stay resident and hit every
    cycle, where LRU would miss every access."""
    cap, w = 4, 6
    c = _KeyCache(max_bytes=cap * SZ + 1)
    assert c.evict_mru
    hits = 0
    for cycle in range(4):
        for k in range(w):
            if c.get(k) is not None:
                hits += 1
            else:
                c.put(k, _mk())
    assert c.d0_bytes <= c.max_bytes
    assert hits >= (cap - 2) * 3, hits
    assert w - 1 in c.d                   # never the just-inserted entry


def test_resident_tier_never_evicts_last_entry():
    c = _KeyCache(max_bytes=1)            # nothing fits
    c.put("only", _mk())
    assert "only" in c.d
    c.put("next", _mk())
    assert "next" in c.d and "only" not in c.d


def test_memo_tier_drops_coldest_first_and_spares_newest():
    c = _KeyCache(max_bytes=100 * SZ, expand_bytes=2 * SZ)
    ks = {i: _mk() for i in range(4)}
    for i, k in ks.items():
        c.put(i, k)
    for i in (0, 1, 2):                   # expand three memos
        c.memoise(ks[i], ks[i].d0)
    assert ks[0].d1_cache is None
    assert ks[1].d1_cache is not None and ks[2].d1_cache is not None
    assert c.d1_bytes == 2 * SZ
    # the newest entry's memo survives even when it alone busts the budget
    c2 = _KeyCache(max_bytes=100 * SZ, expand_bytes=0)
    a, b = _mk(), _mk()
    c2.put("a", a)
    c2.put("b", b)
    c2.memoise(b, b.d0)                   # b is most-recent: spared
    assert b.d1_cache is not None and c2.d1_bytes == SZ
    c2.memoise(a, a.d0)                   # a is not most-recent: dropped
    assert a.d1_cache is None and b.d1_cache is not None


@pytest.mark.parametrize("policy", ["mru", "lru"])
def test_interleaved_get_put_expand_accounting(policy):
    c = _KeyCache(max_bytes=4 * SZ, expand_bytes=2 * SZ, policy=policy)
    for i in range(12):
        k = _mk()
        c.put(i, k)
        if i % 2:
            c.memoise(k, k.d0)
        c.get(max(0, i - 1))
        assert c.d0_bytes <= c.max_bytes or len(c.d) == 1
        assert c.d1_bytes <= c.expand_bytes or (
            list(c.d.values())[-1].d1_cache is not None)
        want0 = sum(c._size0(s) for s in c.d.values())
        want1 = sum(s.d0.numel() * 8 for s in c.d.values()
                    if s.d1 is None and s.d1_cache is not None)
        assert c.d0_bytes == want0 and c.d1_bytes == want1


def test_put_over_a_held_tag_charges_once():
    """A key loaded over one of the same tag replaces it: the budget
    counts the new key's bytes alone (memo included)."""
    c = _KeyCache(max_bytes=100 * SZ)
    old = _mk()
    c.put("k", old)
    c.memoise(old, old.d0)
    c.put("k", _mk(compressed=False))
    assert list(c.d) == ["k"] and c.d0_bytes == 2 * SZ and c.d1_bytes == 0


def _accounts_hold(c):
    assert c.d0_bytes == sum(c._size0(s) for s in c.values())
    assert c.d1_bytes == sum(c._memo(s) for s in c.values())


def test_direct_writes_and_held_keys_are_charged_once():
    """Keys written into the mapping directly are charged like put's and
    refunded once on eviction; a key evicted while its caller held it is
    not memoised, so nothing is charged that no eviction could refund."""
    c = _KeyCache(max_bytes=3 * SZ, expand_bytes=10 * SZ, policy="lru")
    held = _mk()
    c["held"] = held
    c["whole"] = _mk(compressed=False)
    assert c.d0_bytes == 3 * SZ
    for i in range(4):                    # evicts both first entries
        c[i] = _mk()
        _accounts_hold(c)
    assert "held" not in c and "whole" not in c
    c.memoise(held, held.d0)              # the caller's d1 of an evicted key
    assert held.d1_cache is None
    _accounts_hold(c)
    c.memoise(c[3], c[3].d0)
    c[3] = _mk()                          # written over a memoised key
    del c[2]
    _accounts_hold(c)
    assert c.d1_bytes == 0 and c.d0_bytes == 2 * SZ


def test_cache_refuses_unknown_policy():
    with pytest.raises(ValueError):
        _KeyCache(1, policy="fifo")


@pytest.fixture(scope="module")
def cctx():
    """A compressed port context on the chain of test_key_cache.py's."""
    ctx = CkksContext(tiny_params(log_n=8, levels=3), CPU, seed=11,
                      compress_keys=True)
    assert ctx.compress_keys
    return ctx


@pytest.mark.parametrize("drop", ["memo", "whole_cache"])
def test_galh_regen_bit_identity(cctx, drop):
    """A compressed "galh" key regenerates its permuted d1 bit for bit
    after its memo is dropped, and the whole key after a full eviction."""
    g = nttmod.rot_to_galois(3 if drop == "memo" else 5, cctx.params.log_n)
    swk = cctx.galois_key_hoisted(g, 2)
    assert swk.d1 is None and swk.perm is not None
    base = cctx.switching_keys[("gal", g, 2)]
    assert swk.seed == base.seed
    # the plain key made for the twin handed its draw on as the twin's memo
    assert base.d1_cache is None and swk.d1_cache is not None
    d0_first = swk.d0.clone()
    d1_first = cctx.swk_d1(swk).clone()
    if drop == "memo":
        cctx._swk_cache.forget(swk)
        assert swk.d1_cache is None
        swk2 = swk
    else:
        cctx.switching_keys.clear()
        assert cctx._swk_cache.d0_bytes == cctx._swk_cache.d1_bytes == 0
        swk2 = cctx.galois_key_hoisted(g, 2)
        assert swk2 is not swk
    assert torch.equal(swk2.d0, d0_first)
    assert torch.equal(cctx.swk_d1(swk2), d1_first)


def test_inflight_d1_survives_zero_budget(cctx):
    """swk_d1's returned tensor stays usable when the trim drops the memo
    at once."""
    cache = cctx._swk_cache
    old_budget = cache.expand_bytes
    try:
        cache.expand_bytes = 0
        g = nttmod.rot_to_galois(7, cctx.params.log_n)
        swk = cctx.galois_key_hoisted(g, 1)
        cctx.galois_key(3, 1)             # make swk non-most-recent
        d1 = cctx.swk_d1(swk)
        assert d1 is not None
        got = d1.clone()
        assert swk.d1_cache is None       # the cache dropped the memo
        cache.expand_bytes = 1 << 40
        assert torch.equal(got, cctx.swk_d1(swk))
    finally:
        cache.expand_bytes = old_budget


def test_key_budget_arguments():
    """The JAX package's OPTCONV_* key knobs are constructor arguments;
    "auto" compresses from logN 14 on."""
    ctx = CkksContext(tiny_params(log_n=8, levels=1), CPU, seed=1,
                      key_cache_gib=0.5, key_expand_gib=0.25)
    assert not ctx.compress_keys
    c = ctx._swk_cache
    assert (c.max_bytes, c.expand_bytes, c.evict_mru) == (1 << 29, 1 << 28,
                                                          True)
    assert ctx.switching_keys is c
    assert CkksContext(tiny_params(log_n=14, levels=1), CPU,
                       seed=1).compress_keys
    with pytest.raises(ValueError):
        CkksContext(tiny_params(log_n=8, levels=1), CPU, compress_keys="on")


# ---------------------------------------------------------------------------
# the evaluator on compressed keys equals the one on whole keys
# ---------------------------------------------------------------------------

KS_SEED = 13
VARIANTS = {"compressed": dict(compress_keys=True),
            # a resident budget of about one key and no memo: every key is
            # evicted and made again, every d1 regenerated at each use
            "starved": dict(compress_keys=True, key_cache_gib=2.0 ** -20,
                            key_expand_gib=0.0)}


@pytest.fixture(scope="module")
def whole():
    """The reference: every key stored whole, and two ciphertexts."""
    p = tiny_params(log_n=8, levels=3)
    ctx = CkksContext(p, CPU, seed=KS_SEED, compress_keys=False)
    rng = np.random.default_rng(3)
    cts = [ctx.encrypt(ctx.encoder.encode_slots(
        rng.uniform(-1, 1, p.slots), p.scale, p.max_level)) for _ in range(2)]
    return ctx, cts


def _same(a, b):
    assert (a.level, a.scale) == (b.level, b.scale)
    assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_evaluator_on_compressed_keys_is_bit_equal(whole, variant):
    ref, (a, b) = whole
    ctx = CkksContext(ref.params, CPU, seed=KS_SEED, **VARIANTS[variant])
    lvl = a.level
    rots = [1, 2, -3]
    for _ in range(2):          # the second pass runs on cached keys
        _same(ctx.mul_ct(a, b), ref.mul_ct(a, b))
        swk, rswk = ctx.rot_key(5, lvl), ref.rot_key(5, lvl)
        assert swk.d1 is None and rswk.d1 is not None
        assert torch.equal(swk.d0, rswk.d0)
        for x, y in zip(ctx.keyswitch(a.c1, lvl, swk),
                        ref.keyswitch(a.c1, lvl, rswk)):
            assert torch.equal(x, y)
        for k in rots:
            _same(ctx.rotate(a, k), ref.rotate(a, k))
        got, want = ctx.rotate_hoisted(b, rots), ref.rotate_hoisted(b, rots)
        for k in rots:
            _same(got[k], want[k])
        got, want = (ctx.rotate_hoisted_lazy(b, rots),
                     ref.rotate_hoisted_lazy(b, rots))
        for k in rots:
            for x, y in zip(got[k], want[k]):
                assert torch.equal(x, y)
    cache = ctx._swk_cache
    if variant == "starved":
        assert len(cache.d) == 1
        last = next(iter(cache.d.values()))
        assert cache.d0_bytes == last.d0.numel() * 8
        assert cache.d1_bytes in (0, cache.d0_bytes)
    else:
        assert set(cache.d) <= set(ref.switching_keys)
        assert all(k.d1 is None for k in cache.d.values())
        assert cache.d0_bytes * 2 == sum(
            k.d0.numel() * 16 for t, k in ref.switching_keys.items()
            if t in cache.d)


def test_key_cache_counters_match_a_hand_count():
    """The cache's counters (``utils/tracing.py``) on a compressed context
    whose resident budget holds two keys and whose memo budget holds
    none: rotations by 1, 2, 1, 3 make three keys, hit once, regenerate
    one d1 (key 1's, dropped when key 2 came), drop three memos and evict
    one key (the MRU policy takes key 1, the second most recent); the
    gauges follow the cache's bytes."""
    p = tiny_params(log_n=8, levels=3)
    ctx = CkksContext(p, CPU, seed=KS_SEED, compress_keys=True,
                      key_expand_gib=0.0)
    a = ctx.encrypt(ctx.encoder.encode_slots(
        np.random.default_rng(4).uniform(-1, 1, p.slots), p.scale,
        p.max_level))
    cache = ctx._swk_cache
    names = ("keys.made", "keys.hit", "keys.d1_drawn", "keys.memo_dropped",
             "keys.evicted")
    before = tracing.counters()
    ctx.rotate(a, 1)
    cache.max_bytes = 2 * cache.d0_bytes
    for k in (2, 1, 3):
        ctx.rotate(a, k)
    after = tracing.counters()
    moved = {n: after.get(n, 0) - before.get(n, 0) for n in names}
    assert moved == {"keys.made": 3, "keys.hit": 1, "keys.d1_drawn": 1,
                     "keys.memo_dropped": 3, "keys.evicted": 1}
    assert [t[1] for t in cache.d] == [nttmod.rot_to_galois(k, p.log_n)
                                       for k in (2, 3)]
    assert (after["keys.d0_bytes"] - before["keys.d0_bytes"]
            == cache.d0_bytes)
    assert (after["keys.d1_bytes"] - before["keys.d1_bytes"]
            == cache.d1_bytes)
