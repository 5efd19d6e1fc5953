"""CKKS scheme context: keys, encryption and the evaluator.

Counterpart of ``optimal_conv_tpu/ckks/context.py``: the sparse ternary
secret key, symmetric encryption and decryption, the arithmetic
(add/sub/neg, plaintext, constant and ct×ct products with immediate
relinearisation), level and scale management (rescale, drop_level,
set_scale), monomial products, and hybrid RNS key switching with special
primes P behind Galois automorphisms: single rotations, hoisted
rotations (decompose once, rotate many) and their lazy form that leaves
the division by P to the caller.  The JAX package's per-level compiled
closures are ordinary methods that take the level here.

Switching keys are made at first use, at the level where they are used,
and live in ``_KeyCache`` (``switching_keys`` is its ordered dict), an
LRU/MRU cache with two byte budgets as in the JAX package: the resident
halves, and the memos of regenerated d1.  From logN 14 on (or with
``compress_keys=True``) a key is seed-compressed: it stores d0 and the
seed of its uniform half d1, which ``swk_d1`` regenerates
(``core/threefry.py``, on the card the ``d1_regen`` kernel) and
memoises on the key.  Eviction is transparent: a key's seed is a
function of its tag (``_key_seed``), so a key made again is the same key.
The cache counts its work (``utils/tracing.py`` counters): ``keys.hit``
and ``keys.made`` (a tag found, a key drawn), ``keys.evicted`` (a whole
key dropped by the resident budget), ``keys.memo_dropped`` (a d1 memo
dropped by the memo budget) and ``keys.d1_drawn`` (a d1 regenerated from
its seed); the gauges ``keys.d0_bytes`` / ``keys.d1_bytes`` sum the two
tiers over the live caches.  The public evaluator ops (``EVALUATOR_OPS``)
are timed as the outermost evaluator calls while spans are recorded.

Polynomials are ``[..., l+1, N]`` int64 tensors on the context's device,
NTT (bit-reversed) domain and standard form.  The evaluator reads which
limbs it holds from ``q_rows`` / ``p_rows``: all of them here, a rank's
own in the limb-sharded context (``parallel/limbs.py``), which also
overrides the three functions that cross limbs (``_decompose``,
``_mod_down_many``, ``_limb_coeffs``) with their collectives.  The
evaluator functions take leading batch dims, which is how the fused
conv-pack batches its channel products and key switches.

Randomness mirrors the JAX package: the secret key and the encryption
noise come from ``np.random.default_rng(seed)`` in the same draw order,
so one seed gives the same key and the same ciphertexts in both
packages.  A switching key's uniform half is JAX's threefry draw from
the key's seed, bit for bit; its noise e is drawn from a
``torch.Generator`` seeded by the same seed, so d0 differs from the JAX
package's (tests import d0 through ``interop``).
"""

from __future__ import annotations

import hashlib
import weakref
from collections import OrderedDict
from collections.abc import MutableMapping
from dataclasses import dataclass

import numpy as np
import torch

from ..core import modmath as mm
from ..core import ntt as nttmod
from ..core import threefry
from ..device import resolve_device
from ..utils import tracing
from .encoding import Encoder
from .graphs import GraphCache
from .params import CkksParams, DeviceTables
from .types import Ciphertext, Plaintext


@dataclass
class SwitchingKey:
    d0: torch.Tensor            # [beta, l+1+P, N]  NTT + Montgomery
    d1: torch.Tensor | None     # uniform, NTT + Montgomery; None when
    level: int                  # seed-compressed (regenerated from `seed`)
    seed: int | None = None
    # the regenerated d1 of a compressed key, memoised: the cache drops it
    # first under its memo budget, and it regenerates bit for bit
    d1_cache: torch.Tensor | None = None
    # a pre-permuted hoisting key ("galh"): d0/d1 carry φ_g⁻¹ applied in
    # the NTT domain; `perm` is that permutation, re-applied when d1
    # regenerates from the seed
    perm: torch.Tensor | None = None


GIB = 1 << 30
# Budgets of the key cache on the card, in GiB (PERF.md §5 says how they
# were chosen): resident d0 (and the d1 of uncompressed keys), and the
# memos of regenerated d1.
KEY_CACHE_GIB = 16.0
KEY_EXPAND_GIB = 16.0

# the evaluator ops tallied as evaluator calls in the open span
EVALUATOR_OPS = (
    "add", "sub", "neg", "add_plain", "add_const", "mul_plain",
    "mul_scalar_int", "mul_const", "mul_ct", "square", "rescale",
    "drop_level", "set_scale", "keyswitch", "apply_galois", "rotate",
    "conjugate", "rotate_hoisted", "rotate_hoisted_lazy", "galois_acc",
    "ks_finish", "mul_monomial", "mul_by_i", "div_by_i")

# the live key caches, for the gauges
_CACHES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
tracing.gauge("keys.d0_bytes",
              lambda: sum(c.d0_bytes for c in _CACHES.values()))
tracing.gauge("keys.d1_bytes",
              lambda: sum(c.d1_bytes for c in _CACHES.values()))


class _KeyCache(MutableMapping):
    """Switching-key cache with two byte budgets (the JAX package's
    ``_KeyCache``), and the tag → key mapping ``switching_keys``: every
    write goes through ``put``, so every key is charged.

    `max_bytes` bounds the resident halves (d0, and d1 where a key stores
    it); `expand_bytes` bounds the d1 memos of compressed keys.  Keys are
    regenerable from their per-key seed, so dropping one is transparent:
    a miss makes the identical key again.  Neither tier ever drops the
    most-recent entry: it may be the key being expanded right now, and
    its caller may hold no other reference.

    Eviction policy: a fused layer touches its keys cyclically (CtoS
    stages → ReLU → repack → StoC, every layer), and when that set
    exceeds the budget LRU evicts every key just before its next use.
    "mru" evicts the second-most-recent entry instead, which under a
    cyclic scan pins the first budget's worth of keys; every 8th eviction
    still takes the LRU end, so a pinned set that is no longer used
    drains."""

    def __init__(self, max_bytes: int, expand_bytes: int | None = None,
                 policy: str = "mru"):
        if policy not in ("mru", "lru"):
            raise ValueError(f"key eviction policy {policy!r}: mru or lru")
        self.max_bytes = max_bytes
        self.expand_bytes = max_bytes if expand_bytes is None else expand_bytes
        self.d: OrderedDict = OrderedDict()
        self.d0_bytes = 0
        self.d1_bytes = 0
        self.evict_mru = policy == "mru"
        self._evict_n = 0
        _CACHES[id(self)] = self

    @staticmethod
    def _size0(swk: SwitchingKey) -> int:
        b = swk.d0.numel() * 8
        if swk.d1 is not None:
            b *= 2
        return b

    @staticmethod
    def _memo(swk: SwitchingKey) -> int:
        """Bytes of the key's d1 memo (a compressed key's only)."""
        if swk.d1 is None and swk.d1_cache is not None:
            return swk.d0.numel() * 8
        return 0

    def __getitem__(self, key) -> SwitchingKey:
        return self.d[key]

    def __setitem__(self, key, swk: SwitchingKey):
        self.put(key, swk)

    def __delitem__(self, key):
        self._refund(self.d.pop(key))

    def __iter__(self):
        return iter(self.d)

    def __len__(self) -> int:
        return len(self.d)

    def get(self, key, default=None):
        got = self.d.get(key)
        if got is None:
            return default
        self.d.move_to_end(key)
        return got

    def put(self, key, swk: SwitchingKey):
        old = self.d.pop(key, None)
        if old is not None:                 # a key loaded over itself
            self._refund(old)
        self.d[key] = swk
        self.d0_bytes += self._size0(swk)
        self.d1_bytes += self._memo(swk)
        self._trim()

    def holds(self, swk: SwitchingKey) -> bool:
        """Whether the cache holds this key (not one it evicted)."""
        return any(v is swk for v in self.d.values())

    def memoise(self, swk: SwitchingKey, d1: torch.Tensor):
        """Memoise a compressed key's regenerated d1 and charge the memo
        budget.  A key the cache no longer holds (evicted while its
        caller kept it) is not memoised: nothing would refund it."""
        if swk.d1_cache is None and self.holds(swk):
            swk.d1_cache = d1
            self.d1_bytes += self._memo(swk)
            self._trim()

    def forget(self, swk: SwitchingKey):
        """Drop a compressed key's d1 memo and refund it."""
        self.d1_bytes -= self._memo(swk)
        if swk.d1 is None:
            swk.d1_cache = None

    def _trim(self):
        # memo tier: drop the coldest memos first, never the most-recent
        # entry's
        if self.d1_bytes > self.expand_bytes:
            for swk in list(self.d.values())[:-1]:
                if self.d1_bytes <= self.expand_bytes:
                    break
                if self._memo(swk):
                    tracing.count("keys.memo_dropped")
                self.forget(swk)
        # resident tier: evict whole keys; mru drops the second-most-
        # recent entry, lru the coldest
        while self.d0_bytes > self.max_bytes and len(self.d) > 1:
            self._evict_n += 1
            if self.evict_mru and (self._evict_n % 8 or len(self.d) == 2):
                it = reversed(self.d)
                next(it)
                old = self.d.pop(next(it))
            else:
                _, old = self.d.popitem(last=False)
            self._refund(old)
            tracing.count("keys.evicted")

    def _refund(self, old: SwitchingKey):
        self.d0_bytes -= self._size0(old)
        self.d1_bytes -= self._memo(old)


class CkksContext:
    """compress_keys: "auto" (seed-compressed keys from logN 14 on, as the
    JAX package), True or False.  key_cache_gib / key_expand_gib: the
    key cache's resident and memo budgets in GiB.  ntt_backend: the NTT's
    route, "butterfly" (K2/K3 on the card), "mxu" (the four-step matrix
    transform) or "auto" (the JAX package's default: the matrix route at
    logN >= 14 on calls over at most 12 limbs); the JAX package's
    ``OPTCONV_NTT_BACKEND``.  Every route gives the same residues.

    ``_graphs`` captures and replays the bootstrapper's polynomial
    evaluations as CUDA graphs (``ckks/graphs.py``) where ``GRAPHS`` is
    true: all of the context's work runs on the current stream."""

    GRAPHS = True

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        tracing.time_methods(cls, EVALUATOR_OPS)

    def __init__(self, params: CkksParams, device, seed: int = 0,
                 compress_keys: bool | str = "auto",
                 key_cache_gib: float = KEY_CACHE_GIB,
                 key_expand_gib: float = KEY_EXPAND_GIB,
                 ntt_backend: str = "butterfly"):
        if compress_keys not in ("auto", True, False):
            raise ValueError(f"compress_keys={compress_keys!r}: 'auto', True "
                             "or False")
        self.params = params
        self.device = resolve_device(device)
        self.compress_keys = (params.log_n >= 14 if compress_keys == "auto"
                              else compress_keys)
        self._key_budgets = (int(key_cache_gib * GIB), int(key_expand_gib * GIB))
        self.tables = DeviceTables(params, self.device, ntt_backend)
        self.encoder = Encoder(params, self.tables, self._encoder_rows())
        self.rng = np.random.default_rng(seed)
        self._seed = seed
        p = params
        # secret key: sparse ternary, h nonzeros (same draws as JAX)
        s = np.zeros(p.n, dtype=np.int64)
        support = self.rng.choice(p.n, size=p.h, replace=False)
        signs = self.rng.integers(0, 2, size=p.h) * 2 - 1
        s[support] = signs
        self.set_secret_key(s)
        self._pt_cache: dict = {}
        self._perm_cache: dict = {}

    @property
    def ntt(self) -> nttmod.NttContext:
        return self.tables.ntt

    def set_secret_key(self, s: np.ndarray) -> None:
        """Install the secret key from its signed integer coefficients;
        drops every switching key derived from the previous one, and
        every CUDA graph that read them."""
        p = self.params
        self._sk_ints = np.asarray(s, dtype=np.int64)
        res = mm.centered_to_residues(self._sk_ints, p.moduli)
        self.sk_coeff = torch.from_numpy(res).to(self.device)      # [LQP, N]
        all_idx = tuple(range(len(p.moduli)))
        self.sk_ntt = self.ntt.ntt(self.sk_coeff, all_idx)
        # s² for relinearisation: the negacyclic ring product is the
        # pointwise product in the NTT domain
        q, qinv, r2, _ = self.ntt.tabs(all_idx)
        self.sk2_ntt = mm.mul_mod(self.sk_ntt, self.sk_ntt, q, qinv, r2)
        self._swk_cache = _KeyCache(*self._key_budgets)
        # the CUDA graphs read the keys of the old secret by address
        self._graphs = GraphCache(self.GRAPHS, self._swk_cache)

    @property
    def switching_keys(self) -> _KeyCache:
        """tag → SwitchingKey, coldest first: the key cache itself, so an
        entry written here is charged to its budgets like any other."""
        return self._swk_cache

    def _key_seed(self, tag) -> int:
        """Deterministic per-key seed (same derivation as the JAX package)."""
        h = hashlib.sha256(repr((self._seed, tag)).encode()).digest()
        return int.from_bytes(h[:8], "little")

    def _rows(self, t: torch.Tensor, idx) -> torch.Tensor:
        return t.index_select(0, torch.tensor(list(idx), dtype=torch.int64,
                                              device=self.device))

    # ------------------------------------------------------------------
    # the limbs this context holds (all of them; a limb-sharded context
    # holds its own, in increasing order, Q before P)
    # ------------------------------------------------------------------

    def q_rows(self, level: int) -> tuple[int, ...]:
        """The global Q limbs of `level` whose rows this context holds."""
        return self.params.q_idx(level)

    def p_rows(self) -> tuple[int, ...]:
        """The global P limbs whose rows this context holds."""
        return self.params.p_idx()

    def qp_rows(self, level: int) -> tuple[int, ...]:
        return self.q_rows(level) + self.p_rows()

    def _encoder_rows(self):
        """The encoder's rows(level, qp), or None for all limbs.  It must
        not refer to the context: a context in a reference cycle is freed
        only by the cyclic collector, and its keys stay on the card."""
        return None

    # ------------------------------------------------------------------
    # encryption / decryption (symmetric, as the reference)
    # ------------------------------------------------------------------

    def _gauss_ints(self) -> np.ndarray:
        return np.round(self.rng.normal(0.0, self.params.sigma, self.params.n)
                        ).astype(np.int64)

    def _uniform_poly(self, level: int, idx) -> torch.Tensor:
        """The rows `idx` of a uniform polynomial on Q_level: every row is
        drawn, so the generator moves as for the whole polynomial."""
        p = self.params
        rows = np.stack([self.rng.integers(0, p.moduli[i], size=p.n,
                                           dtype=np.uint64)
                         for i in p.q_idx(level)])
        if idx != p.q_idx(level):
            rows = rows[list(idx)]
        return torch.from_numpy(rows.view(np.int64)).to(self.device)

    def encrypt(self, pt: Plaintext) -> Ciphertext:
        """A ciphertext of `pt` (this context's rows of it): on a limb-
        sharded context the rank's rows of the ciphertext the whole
        context of the same seed makes."""
        p = self.params
        level = pt.level
        idx = self.q_rows(level)
        q, qinv, r2, _ = self.ntt.tabs(idx)
        c1 = self._uniform_poly(level, idx)
        e = mm.centered_to_residues(self._gauss_ints(),
                                    [p.moduli[i] for i in idx])
        e_ntt = self.ntt.ntt(torch.from_numpy(e).to(self.device), idx)
        sk = (self.sk_ntt[: level + 1] if idx == p.q_idx(level)
              else self._rows(self.sk_ntt, idx))
        m = pt.poly
        if pt.is_mont:
            m = mm.from_mont(m, q, qinv)
        c1s = mm.mul_mod(c1, sk, q, qinv, r2)
        c0 = mm.add_mod(mm.sub_mod(e_ntt, c1s, q), m, q)
        return Ciphertext(c0, c1, level=level, scale=pt.scale)

    @tracing.spanned("decrypt")
    def decrypt_to_coeffs(self, ct: Ciphertext) -> np.ndarray:
        """→ [l+1, N] coefficient-domain residues of m + noise (host)."""
        idx = self.params.q_idx(ct.level)
        q, qinv, r2, _ = self.ntt.tabs(idx)
        sk = self.sk_ntt[: ct.level + 1]
        m = mm.add_mod(ct.c0, mm.mul_mod(ct.c1, sk, q, qinv, r2), q)
        return self.ntt.intt(m, idx).cpu().numpy()

    def decrypt_decode_coeffs(self, ct: Ciphertext) -> np.ndarray:
        return self.encoder.decode_coeffs(self.decrypt_to_coeffs(ct), ct.scale)

    def decrypt_decode_slots(self, ct: Ciphertext, log_slots=None) -> np.ndarray:
        return self.encoder.decode_slots(self.decrypt_to_coeffs(ct), ct.scale,
                                         log_slots)

    # ------------------------------------------------------------------
    # switching keys
    # ------------------------------------------------------------------

    def _uniform_mont(self, seed: int, beta: int, level: int,
                      perm: torch.Tensor | None = None) -> torch.Tensor:
        """[beta, l+1+P, N] uniform residues of `seed`, JAX's draw bit for
        bit (``core/threefry.py``; the ``d1_regen`` kernel on the card);
        on a sharded context the rows of its limbs, drawn at their
        counters in the whole key."""
        p = self.params
        whole = p.qp_idx(level)
        mine = self.qp_rows(level)
        q, qinv, r2, r1 = self.ntt.tabs(mine)
        rows = None if mine == whole else tuple(whole.index(i) for i in mine)
        return threefry.uniform_mont(seed, beta, q, qinv, r2, r1, p.n, perm,
                                     rows=rows, nqp=len(whole))

    def gen_switching_key(self, s_from_ntt: torch.Tensor, level: int,
                          seed: int) -> SwitchingKey:
        """Key switching s_from → s at `level` (hybrid, P primes).

        s_from_ntt: [l+1+P, N] on the limbs qp_rows(level) (a sharded
        context makes the rows of its own limbs, with no collective).
        d0_d = -a_d·s + e_d + P·w_d·s_from (w_d the CRT indicator of
        digit d), stored NTT + Montgomery; d1_d = a_d, a uniform residue
        from `seed` read directly as the Montgomery form of another
        uniform one.  A compressed key keeps d0 and the seed; ``swk_d1``
        draws a again; its first draw stays on the key as the memo."""
        tracing.count("keys.made")
        p = self.params
        qp = self.qp_rows(level)
        q, qinv, r2, _ = self.ntt.tabs(qp)
        digits = p.digits(level)
        beta = len(digits)
        a_mont = self._uniform_mont(seed, beta, level)        # [beta, nqp, N]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed & ((1 << 63) - 1))
        e = torch.round(torch.randn((beta, 1, p.n), generator=gen,
                                    device=self.device, dtype=torch.float64)
                        * p.sigma).to(torch.int64)
        e_res = torch.where(e >= 0, e, q + e)                  # [beta, nqp, N]
        e_ntt = self.ntt.ntt(e_res, qp)
        sk = self._rows(self.sk_ntt, qp)
        a_s = mm.mont_mul(a_mont, sk, q, qinv)
        pw = np.zeros((beta, len(qp), 1), dtype=np.int64)
        for d, digit in enumerate(digits):
            for i in digit:
                if i in qp:
                    m = p.moduli[i]
                    pw[d, qp.index(i), 0] = (p.big_p % m) * ((1 << 64) % m) % m
        ps = mm.mont_mul(s_from_ntt[None], torch.from_numpy(pw).to(self.device),
                         q, qinv)
        b = mm.add_mod(mm.sub_mod(e_ntt, a_s, q), ps, q)
        d0 = mm.to_mont(b, q, qinv, r2)
        if self.compress_keys:
            return SwitchingKey(d0, None, level, seed=seed, d1_cache=a_mont)
        return SwitchingKey(d0, a_mont, level, seed=seed)

    def swk_d1(self, swk: SwitchingKey) -> torch.Tensor:
        """The key's uniform half: stored, memoised, or regenerated from
        its seed (and permuted by its `perm`) and memoised.  The memo may
        be dropped by the cache's memo budget at once; the tensor returned
        stays valid."""
        if swk.d1 is not None:
            d1 = swk.d1
        elif swk.d1_cache is None:
            tracing.count("keys.d1_drawn")
            d1 = self._uniform_mont(swk.seed, swk.d0.shape[0], swk.level,
                                    swk.perm)
            self._swk_cache.memoise(swk, d1)
        else:
            d1 = swk.d1_cache
        self._graphs.hold(swk, d1)
        return d1

    def _hit(self, key) -> SwitchingKey | None:
        """The cached key of `key` (counted as a hit), or None."""
        swk = self._swk_cache.get(key)
        if swk is not None:
            tracing.count("keys.hit")
        return swk

    def relin_key(self, level: int) -> SwitchingKey:
        """Switching key s² → s at `level` (generated on first use)."""
        key = ("rlk", level)
        swk = self._hit(key)
        if swk is None:
            swk = self.gen_switching_key(
                self._rows(self.sk2_ntt, self.qp_rows(level)), level,
                seed=self._key_seed(key))
            self._swk_cache.put(key, swk)
        return swk

    def galois_key(self, g: int, level: int) -> SwitchingKey:
        """Switching key φ_g(s) → s at `level` (generated on first use)."""
        p = self.params
        g = g % (2 * p.n)
        key = ("gal", g, level)
        swk = self._hit(key)
        if swk is None:
            qp = self.qp_rows(level)
            src, flip = nttmod.galois_perm_coeff(p.log_n, g)
            s_g = nttmod.apply_galois_coeff(
                self._rows(self.sk_coeff, qp),
                torch.from_numpy(src.copy()).to(self.device),
                torch.from_numpy(flip.copy()).to(self.device),
                self.ntt.tabs(qp)[0])
            swk = self.gen_switching_key(self.ntt.ntt(s_g, qp), level,
                                         seed=self._key_seed(key))
            self._swk_cache.put(key, swk)
        return swk

    def rot_key(self, k: int, level: int) -> SwitchingKey:
        return self.galois_key(nttmod.rot_to_galois(k, self.params.log_n), level)

    def galois_key_hoisted(self, g: int, level: int) -> SwitchingKey:
        """φ_g's switching key pre-permuted by φ_g⁻¹ in the NTT domain.

        Pointwise, φ(d)·k = φ(d · φ⁻¹(k)): the hoisted inner product then
        reads the shared unpermuted digits, and only the accumulator pair
        is permuted per rotation, not the β digits.  It shares the plain
        key's seed and carries the permutation, so a compressed one
        regenerates its d1 permuted.  A plain key made here for its twin
        hands its first draw on, permuted, as the twin's memo: a plain key
        that only seeds a twin holds no memo."""
        p = self.params
        g = g % (2 * p.n)
        key = ("galh", g, level)
        swk = self._hit(key)
        if swk is None:
            fresh = ("gal", g, level) not in self._swk_cache
            base = self.galois_key(g, level)
            perm_inv = self.galois_perm(pow(g, -1, 2 * p.n))
            held = base.d1 if base.d1 is not None else base.d1_cache
            d1 = None if held is None else nttmod.apply_galois_ntt(held,
                                                                   perm_inv)
            d0 = nttmod.apply_galois_ntt(base.d0, perm_inv)
            if base.d1 is None:
                swk = SwitchingKey(d0, None, level, seed=base.seed,
                                   d1_cache=d1, perm=perm_inv)
            else:
                swk = SwitchingKey(d0, d1, level, seed=base.seed, perm=perm_inv)
            if fresh:
                self._swk_cache.forget(base)
            self._swk_cache.put(key, swk)
        return swk

    def galois_perm(self, g: int) -> torch.Tensor:
        """NTT-domain permutation of φ_g as a device index tensor."""
        g = g % (2 * self.params.n)
        got = self._perm_cache.get(g)
        if got is None:
            got = torch.from_numpy(
                nttmod.galois_perm_ntt(self.params.log_n, g).copy()
            ).to(self.device)
            self._perm_cache[g] = got
        return got

    def _permute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """φ_g on NTT-domain rows by its ``galois_perm`` (a coefficient-
        sharded context moves shards: ``parallel/coeffs.py``)."""
        return nttmod.apply_galois_ntt(x, perm)

    # ------------------------------------------------------------------
    # key switching core
    # ------------------------------------------------------------------

    def _decompose(self, c1: torch.Tensor, level: int) -> torch.Tensor:
        """[..., l+1, N] NTT → [..., beta, l+1+P, N] coeff-domain digits
        (JAX: ``_build_decompose``)."""
        c1c = self.ntt.intt(c1, self.params.q_idx(level))
        return self.tables.digit_extender(level).extend_digits(c1c)

    def _mod_down_many(self, accs, level: int) -> list:
        """[..., l+1+P, N] QP accumulators → each [..., l+1, N] on
        Q_level, divided by P and rounded, in order (JAX:
        ``_mod_down_builder``; a sharded context gathers the P rows of
        all of them in one collective)."""
        p = self.params
        nq = level + 1
        return [self._mod_down_limbs(acc[..., :nq, :],
                                     self.ntt.intt(acc[..., nq:, :], p.p_idx()),
                                     level, p.q_idx(level)) for acc in accs]

    def _mod_down_limbs(self, acc_q: torch.Tensor, acc_p: torch.Tensor,
                        level: int, idx) -> torch.Tensor:
        """The mod-down on the Q limbs `idx` of `level`: acc_q [..., |idx|,
        N] (NTT domain), acc_p [..., |P|, N] all the P rows in
        coefficient form → (acc_q − [acc_p]_idx)·P⁻¹."""
        qq, qqinv = self.ntt.tabs(idx)[:2]
        ext = self.tables.extender(self.params.p_idx(), idx).extend(acc_p)
        diff = mm.sub_mod(acc_q, self.ntt.ntt(ext, idx), qq)
        return mm.mont_mul(diff, self.tables.p_inv_rows(idx), qq, qqinv)

    def _ks_core(self, digits: torch.Tensor, d0: torch.Tensor,
                 d1: torch.Tensor, level: int, input_ntt: bool = False,
                 lazy: bool = False, idx=None):
        """Digits [..., beta, l+1+P, N] × key → (ks0, ks1) on Q_level
        (JAX: ``_ks_core_builder``).

        input_ntt: the digits are already in the NTT domain (hoisted
        rotations transform them once per ciphertext, not once per
        rotation); else they are coefficient-domain and transformed here.
        lazy: no mod-down; the [..., l+1+P, N] QP accumulators are
        returned, and a caller that sums several divides by P once.
        idx: the limbs of the digits' and the key's rows (default
        qp_rows(level); a limb-sharded step passes its own, lazy)."""
        qp = self.qp_rows(level) if idx is None else idx
        q, qinv = self.ntt.tabs(qp)[:2]
        dig = digits if input_ntt else self.ntt.ntt(digits, qp)
        t0 = mm.mont_mul(dig, d0, q, qinv)
        t1 = mm.mont_mul(dig, d1, q, qinv)
        acc0, acc1 = mm.sum_mod(t0, q, -3), mm.sum_mod(t1, q, -3)
        if lazy:
            return acc0, acc1
        ks0, ks1 = self._mod_down_many((acc0, acc1), level)
        return ks0, ks1

    def keyswitch(self, c1: torch.Tensor, level: int, swk: SwitchingKey):
        if swk.level != level:
            raise ValueError(f"key of level {swk.level} used at level {level}")
        return self._ks_core(self._decompose(c1, level), swk.d0,
                             self.swk_d1(swk), level)

    # ------------------------------------------------------------------
    # evaluator: arithmetic
    # ------------------------------------------------------------------

    def _q(self, level: int) -> torch.Tensor:
        return self.ntt.tabs(self.q_rows(level))[0]

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        _same_level_scale(a, b)
        q = self._q(a.level)
        return Ciphertext(mm.add_mod(a.c0, b.c0, q), mm.add_mod(a.c1, b.c1, q),
                          level=a.level, scale=a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        _same_level_scale(a, b)
        q = self._q(a.level)
        return Ciphertext(mm.sub_mod(a.c0, b.c0, q), mm.sub_mod(a.c1, b.c1, q),
                          level=a.level, scale=a.scale)

    def neg(self, a: Ciphertext) -> Ciphertext:
        q = self._q(a.level)
        return Ciphertext(mm.neg_mod(a.c0, q), mm.neg_mod(a.c1, q),
                          level=a.level, scale=a.scale)

    def add_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        """pt must be in standard form (is_mont=False) at a's level and scale."""
        if pt.is_mont or pt.level != a.level:
            raise ValueError("add_plain needs a standard-form plaintext at "
                             f"level {a.level}, got level {pt.level}, "
                             f"is_mont={pt.is_mont}")
        _same_level_scale(a, pt)
        return Ciphertext(mm.add_mod(a.c0, pt.poly, self._q(a.level)), a.c1,
                          level=a.level, scale=a.scale)

    def _const_col(self, c: int, level: int) -> torch.Tensor:
        """The integer c mod each q_i of `level`, as an [l+1, 1] column."""
        mods = self.params.moduli
        return torch.tensor([c % mods[i] for i in self.q_rows(level)],
                            dtype=torch.int64, device=self.device)[:, None]

    def add_const(self, a: Ciphertext, const: float) -> Ciphertext:
        """Add a scalar to every slot, encoded at the ciphertext's own
        scale.  The column is cached, as ``mul_scalar_int``'s: an upload
        from host memory would drain the stream, and cannot be captured
        in a CUDA graph."""
        c = int(round(const * a.scale))
        key = ("add", c, a.level)
        vals = self._pt_cache.get(key)
        if vals is None:
            vals = self._pt_cache[key] = self._const_col(c, a.level)
        return Ciphertext(mm.add_mod(a.c0, vals, self._q(a.level)), a.c1,
                          level=a.level, scale=a.scale)

    def mul_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        """ct × pt (pt in Montgomery form).  Scales multiply; no rescale."""
        if not pt.is_mont or pt.level != a.level:
            raise ValueError("mul_plain needs a Montgomery-form plaintext at "
                             f"level {a.level}, got level {pt.level}, "
                             f"is_mont={pt.is_mont}")
        q, qinv = self.ntt.tabs(self.q_rows(a.level))[:2]
        return Ciphertext(mm.mont_mul(a.c0, pt.poly, q, qinv),
                          mm.mont_mul(a.c1, pt.poly, q, qinv),
                          level=a.level, scale=a.scale * pt.scale)

    def mul_scalar_int(self, a: Ciphertext, c: int) -> Ciphertext:
        """Multiply the values by an exact integer; the scale is unchanged."""
        q, qinv, r2, _ = self.ntt.tabs(self.q_rows(a.level))
        key = ("scl", c, a.level)
        cm = self._pt_cache.get(key)
        if cm is None:
            cm = mm.to_mont(self._const_col(c, a.level), q, qinv, r2)
            self._pt_cache[key] = cm
        return Ciphertext(mm.mont_mul(a.c0, cm, q, qinv),
                          mm.mont_mul(a.c1, cm, q, qinv),
                          level=a.level, scale=a.scale)

    def mul_const(self, a: Ciphertext, const: float,
                  const_scale: float) -> Ciphertext:
        """Multiply by round(const·const_scale)/const_scale; scale *= const_scale."""
        out = self.mul_scalar_int(a, int(round(const * const_scale)))
        return out.with_scale(a.scale * const_scale)

    def mul_ct(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """ct × ct with immediate relinearisation.  Scales multiply; no
        rescale."""
        if a.level != b.level:
            raise ValueError(f"operands differ: level {a.level}/{b.level}")
        lvl = a.level
        q, qinv, r2, _ = self.ntt.tabs(self.q_rows(lvl))
        d0 = mm.mul_mod(a.c0, b.c0, q, qinv, r2)
        d1 = mm.add_mod(mm.mul_mod(a.c0, b.c1, q, qinv, r2),
                        mm.mul_mod(a.c1, b.c0, q, qinv, r2), q)
        d2 = mm.mul_mod(a.c1, b.c1, q, qinv, r2)
        ks0, ks1 = self.keyswitch(d2, lvl, self.relin_key(lvl))
        return Ciphertext(mm.add_mod(d0, ks0, q), mm.add_mod(d1, ks1, q),
                          level=lvl, scale=a.scale * b.scale)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.mul_ct(a, a)

    # ------------------------------------------------------------------
    # evaluator: level and scale management
    # ------------------------------------------------------------------

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Divide by q_level and round; level-1, scale /= q_level."""
        lvl = a.level
        if lvl < 1:
            raise ValueError("rescale needs level ≥ 1")
        q_top = self.params.q_moduli[lvl]
        c0, c1 = self._rescale_pair(a.c0, a.c1, lvl)
        return Ciphertext(c0, c1, level=lvl - 1, scale=a.scale / q_top)

    def _rescale_pair(self, c0: torch.Tensor, c1: torch.Tensor, lvl: int):
        """[..., lvl+1, N] → [..., lvl, N], both halves: (c − [c mod
        q_top]) / q_top with the centered remainder (JAX: ``_rescale_f``).
        The top limb's coefficient form comes from ``_limb_coeffs``."""
        t0, t1 = self._limb_coeffs(c0, c1, lvl)
        idx = self.q_rows(lvl - 1)
        k = len(idx)
        if not k:                      # a sharded rank with no limb below
            return c0[..., :0, :], c1[..., :0, :]
        return (self._rescale_limbs(c0[..., :k, :], t0, lvl, idx),
                self._rescale_limbs(c1[..., :k, :], t1, lvl, idx))

    def _limb_coeffs(self, c0: torch.Tensor, c1: torch.Tensor, limb: int):
        """The Q limb `limb` of both halves in coefficient form, two
        [..., 1, N] (a sharded context broadcasts it from its owner)."""
        return tuple(self.ntt.intt(c[..., limb:limb + 1, :], (limb,))
                     for c in (c0, c1))

    def _rescale_limbs(self, c: torch.Tensor, t: torch.Tensor, lvl: int,
                       idx) -> torch.Tensor:
        """The rescale on the Q limbs `idx` (below lvl): c [..., |idx|, N],
        t [..., 1, N] the top limb in coefficient form."""
        p = self.params
        q_top = p.q_moduli[lvl]
        q, qinv, _, r1 = self.ntt.tabs(idx)
        key = ("rescale", lvl, idx)
        qtop_mod = self._pt_cache.get(key)
        if qtop_mod is None:
            qtop_mod = torch.tensor([q_top % p.q_moduli[i] for i in idx],
                                    dtype=torch.int64, device=self.device)[:, None]
            self._pt_cache[key] = qtop_mod
        red = mm.mont_mul(t, r1, q, qinv)                       # t mod q_i
        red = mm.centred_sub(red, t, q_top // 2, qtop_mod, q)
        red_ntt = self.ntt.ntt(red, idx)
        return mm.mont_mul(mm.sub_mod(c, red_ntt, q),
                           self.tables.qlast_inv_rows(lvl, idx), q, qinv)

    def drop_level(self, a: Ciphertext, levels: int) -> Ciphertext:
        if levels <= 0:
            return a
        nl = a.level - levels
        k = len(self.q_rows(nl))
        return Ciphertext(a.c0[..., :k, :], a.c1[..., :k, :], level=nl,
                          scale=a.scale)

    def set_scale(self, a: Ciphertext, target: float) -> Ciphertext:
        """Multiply by round(target·q_level/scale), then rescale, so that
        the scale is exactly `target`; consumes one level."""
        q_top = self.params.q_moduli[a.level]
        c = int(round(target * q_top / a.scale))
        if c < 1:
            raise ValueError(f"set_scale: scale {a.scale} at level {a.level} "
                             f"cannot reach {target}")
        out = self.mul_scalar_int(a, c).with_scale(a.scale * c)
        # the float epsilon of the division is absorbed exactly
        return self.rescale(out).with_scale(target)

    # ------------------------------------------------------------------
    # evaluator: automorphisms
    # ------------------------------------------------------------------

    def apply_galois(self, a: Ciphertext, g: int) -> Ciphertext:
        """φ_g, then key switching back to s."""
        g = g % (2 * self.params.n)
        if g == 1:
            return a
        lvl = a.level
        swk = self.galois_key(g, lvl)
        perm = self.galois_perm(g)
        c0p = self._permute(a.c0, perm)
        c1p = self._permute(a.c1, perm)
        ks0, ks1 = self.keyswitch(c1p, lvl, swk)
        return Ciphertext(mm.add_mod(c0p, ks0, self._q(lvl)), ks1, level=lvl,
                          scale=a.scale)

    def rotate(self, a: Ciphertext, k: int) -> Ciphertext:
        """Left-rotate the slots by k."""
        if k % self.params.slots == 0:
            return a
        return self.apply_galois(a, nttmod.rot_to_galois(k, self.params.log_n))

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.apply_galois(a, 2 * self.params.n - 1)

    def _dec_ntt(self, c1: torch.Tensor, level: int) -> torch.Tensor:
        """c1 [..., l+1, N] → its key-switch digits in the NTT domain,
        [..., beta, l+1+P, N]: paid once per hoisted ciphertext.  φ_g
        commutes with the digit split (both act coefficient by
        coefficient), so permuting these digits equals splitting the
        permuted c1."""
        return self.ntt.ntt(self._decompose(c1, level), self.qp_rows(level))

    def rotate_hoisted(self, a: Ciphertext, rots) -> dict:
        """{k: a rotated by k} for every k of `rots`: decompose once,
        rotate many.  Each rotation is one inner product of the shared
        digits with a pre-permuted key (``galois_key_hoisted``), two
        mod-downs and a permutation of the result pair.  The mod-down
        commutes with the automorphism up to ±1 a coefficient, far below
        the key-switch noise, so the residues differ from ``rotate``'s."""
        p = self.params
        lvl = a.level
        q = self._q(lvl)
        digits_ntt = self._dec_ntt(a.c1, lvl)
        out = {}
        for k in rots:
            if k % p.slots == 0:
                out[k] = a
                continue
            g = nttmod.rot_to_galois(k, p.log_n)
            swk = self.galois_key_hoisted(g, lvl)
            perm = self.galois_perm(g)
            ks0, ks1 = self._ks_core(digits_ntt, swk.d0, self.swk_d1(swk),
                                     lvl, input_ntt=True)
            out[k] = Ciphertext(
                nttmod.apply_galois_ntt(mm.add_mod(a.c0, ks0, q), perm),
                nttmod.apply_galois_ntt(ks1, perm), level=lvl, scale=a.scale)
        return out

    def rotate_hoisted_lazy(self, a: Ciphertext, rots) -> dict:
        """Double-hoisted rotations (Bossuat et al. 2021): decompose once
        and skip the mod-down, returning for each k the raw triple

            (φ_k(c0) on Q_lvl,  acc0 on Q_lvl·P,  acc1 on Q_lvl·P).

        A baby-step giant-step caller multiplies the triples by
        QP-encoded plaintexts, sums them per giant step and divides by P
        once per giant step instead of twice per rotation."""
        p = self.params
        lvl = a.level
        digits_ntt = self._dec_ntt(a.c1, lvl)
        out = {}
        for k in rots:
            if k % p.slots == 0:
                out[k] = self._hoist_identity(a.c0, a.c1, lvl)
                continue
            g = nttmod.rot_to_galois(k, p.log_n)
            swk = self.galois_key_hoisted(g, lvl)
            perm = self.galois_perm(g)
            a0, a1 = self._ks_core(digits_ntt, swk.d0, self.swk_d1(swk), lvl,
                                   input_ntt=True, lazy=True)
            out[k] = (nttmod.apply_galois_ntt(a.c0, perm),
                      nttmod.apply_galois_ntt(a0, perm),
                      nttmod.apply_galois_ntt(a1, perm))
        return out

    def _hoist_identity(self, c0: torch.Tensor, c1: torch.Tensor, level: int):
        """(c0, c1) as the lazy triple of the identity rotation: a1 holds
        P·c1 on the Q rows and 0 on the P rows, so the mod-down gives
        back c1 exactly; a0 = 0 (no key switch happened)."""
        p = self.params
        idx = self.q_rows(level)
        nq, npr = len(idx), len(self.p_rows())
        q, qinv = self.ntt.tabs(idx)[:2]
        key = ("pmont", level)
        pm = self._pt_cache.get(key)
        if pm is None:
            # Montgomery form of the scalar P on each Q limb
            pm = torch.tensor([(p.big_p % m) * ((1 << 64) % m) % m
                               for m in (p.moduli[i] for i in idx)],
                              dtype=torch.int64, device=self.device)[:, None]
            self._pt_cache[key] = pm
        top = mm.mont_mul(c1, pm, q, qinv)
        lead = tuple(c1.shape[:-2])
        a1 = torch.cat([top, top.new_zeros(lead + (npr, p.n))], dim=-2)
        return c0, top.new_zeros(lead + (nq + npr, p.n)), a1

    def galois_acc(self, c0, c1, g: int, lvl: int, aq0, ap0, ap1):
        """φ_g of (c0, c1) with a lazy key switch, folded into running
        sums: (aq0 on Q, ap0/ap1 on QP) ← (aq0 + φc0, ap0 + acc0,
        ap1 + acc1).  G giant rotations then cost one pair of mod-downs
        (``ks_finish``) instead of G, and round once."""
        p = self.params
        g = g % (2 * p.n)
        swk = self.galois_key(g, lvl)
        perm = self.galois_perm(g)
        qp_q = self.ntt.tabs(self.qp_rows(lvl))[0]
        c0p = nttmod.apply_galois_ntt(c0, perm)
        c1p = nttmod.apply_galois_ntt(c1, perm)
        a0, a1 = self._ks_core(self._decompose(c1p, lvl), swk.d0,
                               self.swk_d1(swk), lvl, lazy=True)
        return (mm.add_mod(aq0, c0p, self._q(lvl)), mm.add_mod(ap0, a0, qp_q),
                mm.add_mod(ap1, a1, qp_q))

    def ks_finish(self, g0c0, g0c1, aq0, ap0, ap1, lvl: int):
        """(g0c0, g0c1) + the lazy sums of ``galois_acc``, divided by P:
        → the two polynomials of a ciphertext on Q_lvl."""
        q = self._q(lvl)
        md0, md1 = self._mod_down_many((ap0, ap1), lvl)
        o0 = mm.add_mod(mm.add_mod(aq0, md0, q), g0c0, q)
        o1 = mm.add_mod(md1, g0c1, q)
        return o0, o1

    # ------------------------------------------------------------------
    # monomial products (exact, scale-free): ct × X^k
    # ------------------------------------------------------------------

    def mul_monomial(self, a: Ciphertext, k: int) -> Ciphertext:
        """Multiply by X^k (k may be negative); exact in RNS."""
        k = k % (2 * self.params.n)
        if k == 0:
            return a
        mono = self.monomial_pt(k, a.level)
        q, qinv = self.ntt.tabs(self.q_rows(a.level))[:2]
        return Ciphertext(mm.mont_mul(a.c0, mono, q, qinv),
                          mm.mont_mul(a.c1, mono, q, qinv),
                          level=a.level, scale=a.scale)

    def monomial_pt(self, k: int, level: int) -> torch.Tensor:
        """NTT + Montgomery form of X^k at `level` (cached)."""
        p = self.params
        key = ("mono", k, level)
        mono_ntt = self._pt_cache.get(key)
        if mono_ntt is None:
            idx = self.q_rows(level)
            mono = np.zeros(p.n, dtype=np.int64)
            if k < p.n:
                mono[k] = 1
            else:
                mono[k - p.n] = -1
            res = mm.centered_to_residues(mono, [p.moduli[i] for i in idx])
            q, qinv, r2, _ = self.ntt.tabs(idx)
            mono_ntt = mm.to_mont(
                self.ntt.ntt(torch.from_numpy(res).to(self.device), idx),
                q, qinv, r2)
            self._pt_cache[key] = mono_ntt
        return mono_ntt

    def mul_by_i(self, a: Ciphertext) -> Ciphertext:
        return self.mul_monomial(a, self.params.n // 2)

    def div_by_i(self, a: Ciphertext) -> Ciphertext:
        return self.mul_monomial(a, 3 * self.params.n // 2)


tracing.time_methods(CkksContext, EVALUATOR_OPS)


def _same_level_scale(a, b) -> None:
    if a.level != b.level or abs(a.scale / b.scale - 1) >= 1e-9:
        raise ValueError(f"operands differ: level {a.level}/{b.level}, "
                         f"scale {a.scale}/{b.scale}")
