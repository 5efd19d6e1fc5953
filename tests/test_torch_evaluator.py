"""The port's evaluator against the JAX package (CPU, plain versions).

Every case is bit-exact: the same seed gives both packages the same
secret key and, drawing in the same order, the same ciphertexts; the
relinearisation, Galois and pre-permuted hoisting keys are made by the
JAX context and carried across through ``interop``.  Residues are
compared with ``np.array_equal``, levels and scales with ``==``.

The chain has two special primes, so the key-switch digits hold two
limbs, and the cases run at level 4: five limbs, digits (2, 2, 1), a
ragged last digit.  A hoisted rotation is compared with the JAX hoisted
rotation on the same pre-permuted key, and with the port's own plain
``rotate`` only after decryption: the mod-down commutes with the
automorphism up to ±1 a coefficient.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.utils.serialization import save_keys

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams

CPU = torch.device("cpu")
SPEC = dict(log_n=10, logq=(50, 40, 40, 40, 40, 40), logp=(55, 55),
            log_scale=30, h=64)
SEED = 21
LEVEL = 4

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


class Pair:
    """A JAX context and a port context on the same secret key, with two
    ciphertexts that both encrypted from the same draws."""

    def __init__(self):
        self.j = JaxContext(JaxParams(**SPEC), seed=SEED)
        self.t = CkksContext(CkksParams(**SPEC), CPU, seed=SEED)
        rng = np.random.default_rng(2)
        n = self.j.params.slots
        self.x = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        self.y = rng.uniform(-1, 1, n)
        scale = self.j.params.scale
        self.ja, self.ta = self._encrypt(self.x, scale)
        self.jb, self.tb = self._encrypt(self.y, scale)

    def _encrypt(self, z, scale):
        jct = self.j.encrypt(self.j.encoder.encode_slots(z, scale, LEVEL))
        tct = self.t.encrypt(self.t.encoder.encode_slots(z, scale, LEVEL))
        return jct, tct

    def sync_keys(self) -> int:
        """Carry every switching key the JAX context holds across."""
        keys = {key: (np.asarray(swk.d0), np.asarray(self.j.swk_d1(swk)))
                for key, swk in self.j._swk_cache.d.items()}
        return interop.load_switching_keys(self.t, keys)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _same_poly(t, j):
    assert np.array_equal(interop.to_numpy(t), np.asarray(j))


def _same(t, j):
    assert t.level == j.level and t.scale == j.scale
    _same_poly(t.c0, j.c0)
    _same_poly(t.c1, j.c1)


def test_digits_are_ragged_and_inputs_equal(pair):
    assert [len(d) for d in pair.t.params.digits(LEVEL)] == [2, 2, 1]
    assert np.array_equal(pair.t._sk_ints, pair.j._sk_ints)
    _same_poly(pair.t.sk2_ntt, pair.j.sk2_ntt)
    _same(pair.ta, pair.ja)
    _same(pair.tb, pair.jb)


def _plain_ops(name, ctx, a, b, enc):
    """One evaluator op by name, written once for both packages."""
    scale = ctx.params.scale
    if name == "neg":
        return ctx.neg(a)
    if name == "add_plain":
        return ctx.add_plain(a, enc.encode_slots(np.arange(7) / 7.0, scale,
                                                 LEVEL, mont=False))
    if name == "add_const":
        return ctx.add_const(a, -0.37)
    if name == "mul_plain":
        return ctx.mul_plain(a, enc.encode_slots(np.arange(9) / 9.0, scale,
                                                 LEVEL))
    if name == "mul_scalar_int":
        return ctx.mul_scalar_int(ctx.mul_scalar_int(a, 12345), -3)
    if name == "mul_const":
        return ctx.mul_const(a, 0.7071067811865476, 2.0**33)
    if name == "mul_ct":
        return ctx.mul_ct(a, b)
    if name == "square_rescale":
        return ctx.rescale(ctx.square(a))
    if name == "set_scale":
        return ctx.set_scale(a, scale * 1.2345)
    if name == "drop_level":
        return ctx.drop_level(ctx.drop_level(a, 0), 2)
    if name == "rotate":
        return ctx.rotate(a, 3)
    if name == "rotate_full_turn":
        return ctx.rotate(a, ctx.params.slots)
    if name == "conjugate":
        return ctx.conjugate(a)
    if name == "mul_by_i":
        return ctx.mul_by_i(a)
    assert name == "div_by_i"
    return ctx.div_by_i(ctx.mul_monomial(a, 5))


OPS = ["neg", "add_plain", "add_const", "mul_plain", "mul_scalar_int",
       "mul_const", "mul_ct", "square_rescale", "set_scale", "drop_level",
       "rotate", "rotate_full_turn", "conjugate", "mul_by_i", "div_by_i"]


@pytest.mark.parametrize("name", OPS)
def test_op_bit_exact(pair, name):
    want = _plain_ops(name, pair.j, pair.ja, pair.jb, pair.j.encoder)
    pair.sync_keys()
    got = _plain_ops(name, pair.t, pair.ta, pair.tb, pair.t.encoder)
    _same(got, want)


ROTS = [0, 1, 5, -2]


def test_rotate_hoisted_bit_exact(pair):
    want = pair.j.rotate_hoisted(pair.ja, ROTS)
    assert pair.sync_keys() >= 6              # three "gal" and three "galh"
    got = pair.t.rotate_hoisted(pair.ta, ROTS)
    assert set(got) == set(want) == set(ROTS)
    for k in ROTS:
        _same(got[k], want[k])
    # against the port's own plain rotation only after decryption: 1e-4,
    # the bar of the JAX package's rotation tests at scale 2^30
    for k in ROTS[1:]:
        np.testing.assert_allclose(
            pair.t.decrypt_decode_slots(got[k]),
            pair.t.decrypt_decode_slots(pair.t.rotate(pair.ta, k)), atol=1e-4)
        np.testing.assert_allclose(pair.t.decrypt_decode_slots(got[k]),
                                   np.roll(pair.x, -k), atol=1e-4)


def test_lazy_rotations_and_accumulators_bit_exact(pair):
    """rotate_hoisted_lazy (the identity triple included), galois_acc
    over two giant steps and ks_finish, as the double-hoisted BSGS chains
    them."""
    jt, tt = pair.j, pair.t
    want = jt.rotate_hoisted_lazy(pair.ja, ROTS)
    pair.sync_keys()
    got = tt.rotate_hoisted_lazy(pair.ta, ROTS)
    for k in ROTS:
        assert len(got[k]) == len(want[k]) == 3
        for t, j in zip(got[k], want[k]):
            assert tuple(t.shape) == tuple(j.shape)
            _same_poly(t, j)
    # fold two rotations' triples into the lazy sums, then finish
    p = jt.params
    nq, nqp = LEVEL + 1, LEVEL + 1 + p.num_p
    import jax.numpy as jnp
    jacc = (jnp.zeros((nq, p.n), jnp.uint64), jnp.zeros((nqp, p.n), jnp.uint64),
            jnp.zeros((nqp, p.n), jnp.uint64))
    tacc = tuple(torch.zeros(r, p.n, dtype=torch.int64) for r in (nq, nqp, nqp))
    for g in (5, 25, 2 * p.n - 1):
        jacc = jt.galois_acc(pair.ja.c0, pair.ja.c1, g, LEVEL, *jacc)
        pair.sync_keys()
        tacc = tt.galois_acc(pair.ta.c0, pair.ta.c1, g, LEVEL, *tacc)
        for t, j in zip(tacc, jacc):
            _same_poly(t, j)
    jo = jt.ks_finish(pair.jb.c0, pair.jb.c1, *jacc, LEVEL)
    to = tt.ks_finish(pair.tb.c0, pair.tb.c1, *tacc, LEVEL)
    _same_poly(to[0], jo[0])
    _same_poly(to[1], jo[1])
    # the identity triple divides back to the ciphertext exactly
    c0, a0, a1 = got[0]
    z = torch.zeros_like(c0)
    back = tt.ks_finish(z, z, c0, a0, a1, LEVEL)
    assert torch.equal(back[0], pair.ta.c0) and torch.equal(back[1], pair.ta.c1)


def test_load_keys_archive(pair, tmp_path):
    """A ``save_keys`` archive with all three key kinds installs the same
    tensors as the direct import, and the secret key with them."""
    pair.j.relin_key(LEVEL)
    pair.j.galois_key_hoisted(5, LEVEL)
    path = str(tmp_path / "keys.npz")
    save_keys(path, pair.j)
    fresh = CkksContext(CkksParams(**SPEC), CPU, seed=SEED + 1)
    n = interop.load_keys(path, fresh)
    assert n == len(pair.j._swk_cache.d)
    assert np.array_equal(fresh._sk_ints, pair.j._sk_ints)
    for tag in (("rlk", LEVEL), ("gal", 5, LEVEL), ("galh", 5, LEVEL)):
        jk = pair.j._swk_cache.d[tag]
        _same_poly(fresh.switching_keys[tag].d0, jk.d0)
        _same_poly(fresh.switching_keys[tag].d1, pair.j.swk_d1(jk))
    with pytest.raises(ValueError):
        interop.load_switching_keys(fresh, {("bogus", 1, 0): (None, None)})


def test_port_keys_decrypt_level(pair):
    """The port's own keys (torch.Generator) carry other noise than the
    JAX package's, so results agree only after decryption: the product to
    1e-3, rotation and conjugate to 1e-4 on values in [-1, 1] at scale
    2^30, the bars of the JAX package's own evaluator tests."""
    own = CkksContext(CkksParams(**SPEC), CPU, seed=SEED)
    scale = own.params.scale
    a = own.encrypt(own.encoder.encode_slots(pair.x, scale, LEVEL))
    b = own.encrypt(own.encoder.encode_slots(pair.y, scale, LEVEL))
    prod = own.rescale(own.mul_ct(a, b))
    assert prod.level == LEVEL - 1
    np.testing.assert_allclose(own.decrypt_decode_slots(prod), pair.x * pair.y,
                               atol=1e-3)
    np.testing.assert_allclose(own.decrypt_decode_slots(own.rotate(a, 7)),
                               np.roll(pair.x, -7), atol=1e-4)
    np.testing.assert_allclose(own.decrypt_decode_slots(own.conjugate(a)),
                               np.conj(pair.x), atol=1e-4)
    hoisted = own.rotate_hoisted(a, [2, 9])
    for k, ct in hoisted.items():
        np.testing.assert_allclose(own.decrypt_decode_slots(ct),
                                   np.roll(pair.x, -k), atol=1e-4)
    np.testing.assert_allclose(own.decrypt_decode_slots(own.mul_by_i(a)),
                               1j * pair.x, atol=1e-4)
    with pytest.raises(ValueError):
        own.mul_ct(a, own.drop_level(b, 1))
    with pytest.raises(ValueError):
        own.mul_plain(a, own.encoder.encode_slots(pair.y, scale, LEVEL,
                                                  mont=False))
