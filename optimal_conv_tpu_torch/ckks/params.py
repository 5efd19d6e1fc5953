"""CKKS parameter sets: modulus chains, scale, key-switch layout.

Counterpart of ``optimal_conv_tpu/ckks/params.py``.  An RNS chain
Q = [q0..qL] (level ℓ uses q0..qℓ), special primes P for hybrid key
switching, scale 2^30, sparse ternary secret of weight h, σ = 3.2.
``boot_params`` loads the Go fork's exact chain from
``ref_bootstrap_params.json`` (a byte-for-byte copy of the JAX
package's file).

Parameters are pure host data.  The tables that live on a device (NTT
twiddles, extender constants) are built by ``DeviceTables`` once per
(parameters, device) and owned by the context that asked for them.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import modmath as mm
from ..core import ntt as nttmod
from ..core import rns


@dataclass(frozen=True)
class CkksParams:
    log_n: int
    logq: tuple[int, ...]          # Q-chain bit sizes, level 0 first
    logp: tuple[int, ...]          # special primes
    log_scale: int = 30
    h: int = 192                   # secret key Hamming weight
    sigma: float = 3.2
    # level indices of the pipeline stages (bootstrapping layout); None
    # for parameter sets that cannot bootstrap.  compare=False keeps the
    # dataclass hashable.
    boot_layout: dict | None = field(default=None, compare=False)
    q_explicit: tuple[int, ...] | None = None
    p_explicit: tuple[int, ...] | None = None

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def slots(self) -> int:
        return self.n // 2

    @property
    def log_slots(self) -> int:
        return self.log_n - 1

    @property
    def scale(self) -> float:
        return float(1 << self.log_scale)

    @property
    def max_level(self) -> int:
        return len(self.logq) - 1

    @functools.cached_property
    def _generated(self) -> list[int]:
        return mm.gen_ntt_primes(self.log_n, list(self.logq) + list(self.logp))

    @functools.cached_property
    def q_moduli(self) -> list[int]:
        if self.q_explicit is not None:
            assert len(self.q_explicit) == len(self.logq)
            return list(self.q_explicit)
        return self._generated[: len(self.logq)]

    @functools.cached_property
    def p_moduli(self) -> list[int]:
        if self.p_explicit is not None:
            assert len(self.p_explicit) == len(self.logp)
            return list(self.p_explicit)
        return self._generated[len(self.logq):]

    @functools.cached_property
    def moduli(self) -> list[int]:
        """All limbs, Q first then P (global limb indexing)."""
        return self.q_moduli + self.p_moduli

    @property
    def num_p(self) -> int:
        return len(self.logp)

    @functools.cached_property
    def big_p(self) -> int:
        out = 1
        for p in self.p_moduli:
            out *= p
        return out

    # ---- limb index helpers --------------------------------------------

    def q_idx(self, level: int) -> tuple[int, ...]:
        return tuple(range(level + 1))

    def p_idx(self) -> tuple[int, ...]:
        lq = len(self.logq)
        return tuple(range(lq, lq + self.num_p))

    def qp_idx(self, level: int) -> tuple[int, ...]:
        return self.q_idx(level) + self.p_idx()

    def digits(self, level: int) -> list[tuple[int, ...]]:
        """Key-switch decomposition digits: groups of ≤|P| Q-limbs."""
        alpha = max(self.num_p, 1)
        idx = self.q_idx(level)
        return [idx[i:i + alpha] for i in range(0, len(idx), alpha)]


class DeviceTables:
    """The device-resident tables of one parameter set on one device:
    the NTT context (on the route `ntt_backend`, ``core.ntt.BACKENDS``)
    and, built on first use, the basis extenders and the per-level
    inverse constants."""

    def __init__(self, params: CkksParams, device: torch.device,
                 ntt_backend: str = "butterfly"):
        self.params = params
        self.device = device
        self.ntt = nttmod.NttContext(params.moduli, params.log_n, device,
                                     backend=ntt_backend)
        self._cache: dict = {}

    def _get(self, key, build):
        got = self._cache.get(key)
        if got is None:
            got = build()
            self._cache[key] = got
        return got

    def extender(self, src: tuple[int, ...], dst: tuple[int, ...]):
        mods = self.params.moduli
        return self._get(("ext", src, dst), lambda: rns.BasisExtender(
            [mods[i] for i in src], [mods[i] for i in dst], self.device))

    def digit_extender(self, level: int, dst=None):
        """The extender of every digit of `level` to the limbs `dst`
        (default all of Q_level·P; a limb-sharded step asks for its own)."""
        p = self.params
        dst = p.qp_idx(level) if dst is None else tuple(dst)
        return self._get(("dext", level, dst), lambda: rns.DigitExtender(
            p.digits(level), dst, p.moduli, self.device))

    def p_inv_rows(self, idx: tuple[int, ...]) -> torch.Tensor:
        """P^{-1} mod q_i (Montgomery form) for the Q limbs `idx`: [|idx|, 1]."""
        p = self.params
        return self._get(("pinv", idx), lambda: _col(
            [pow(p.big_p % q, -1, q) * ((1 << 64) % q) % q
             for q in (p.q_moduli[i] for i in idx)], self.device))

    def qlast_inv_rows(self, level: int, idx: tuple[int, ...]) -> torch.Tensor:
        """q_level^{-1} mod q_i (Montgomery) for the Q limbs `idx` below
        `level`: [|idx|, 1]."""
        p = self.params
        ql = p.q_moduli[level]
        return self._get(("qlinv", level, idx), lambda: _col(
            [pow(ql % q, -1, q) * ((1 << 64) % q) % q
             for q in (p.q_moduli[i] for i in idx)], self.device))


def _col(vals, device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int64, device=device)[:, None]


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

REF_PARAMS_JSON = os.path.join(os.path.dirname(__file__),
                               "ref_bootstrap_params.json")


def ref_fork_chain(index: int = 6) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Exact (Q, P) moduli of the Go fork's DefaultBootstrapParams[index]."""
    with open(REF_PARAMS_JSON) as f:
        e = json.load(f)[index]
    return tuple(e["q_chain"]), tuple(e["p"])


def boot_params(log_n: int = 16) -> CkksParams:
    """The Go fork's exact chain, DefaultBootstrapParams[6]: 28 Q-limbs
    + 5 P-limbs, logQP 1553, scale 2^30, h = 192.  All primes are
    ≡ 1 mod 2^17, so the chain instantiates at any log_n ≤ 16.

    Level layout, bottom to top (the fork's section order Residual ++
    StC ++ ReLU ++ Sine ++ CtS):
        0      2^55        conv output / bootstrap base
        1      2^49        conv inputs and kernels
        2-3    2^60 ×2     StoC (3 DFT groups, the top level holds 2)
        4      2^42        post-ReLU repack masks
        5-15   2^30 ×11    minimax ReLU (tight deg 7∘7∘13 + the product)
        16-23  2^55 ×8     EvalMod
        24-27  2^53 ×4     CtoS
        P      2^61 ×5     hybrid key switching (alpha = 5, beta ≤ 6)
    """
    q, p = ref_fork_chain(6)
    logq = tuple(round(np.log2(m)) for m in q)
    logp = tuple(round(np.log2(m)) for m in p)
    n_stoc, n_relu, n_mod, n_ctos = 2, 11, 8, 4
    layout = _boot_layout(n_stoc, n_relu, n_mod, n_ctos)
    layout["stoc_groups"] = 3                    # 3 matrices on 2 levels
    return CkksParams(log_n=log_n, logq=logq, logp=logp,
                      log_scale=30, h=192, sigma=3.2, boot_layout=layout,
                      q_explicit=q, p_explicit=p)


def bl_boot_params(log_n: int = 16) -> CkksParams:
    """The Go fork's DefaultBootstrapParams[7], the chain its prior-art
    baseline bootstraps on: 28 Q-limbs + 5 P-limbs, logQP 1582, scale
    2^30, h = 192.  Above level 15 it is ``boot_params``' chain; below,
    the ReLU's eleven 30-bit primes sit under the StoC primes, so a whole
    bootstrap (StoC right under EvalMod) is followed by the ReLU:
        0-1    2^55, 2^60  residual
        2-12   2^30 ×11    minimax ReLU
        13-15  2^60 ×3     StoC (3 DFT groups, one a level)
        16-23  2^55 ×8     EvalMod
        24-27  2^53 ×4     CtoS
    """
    q, p = ref_fork_chain(7)
    logq = tuple(round(np.log2(m)) for m in q)
    logp = tuple(round(np.log2(m)) for m in p)
    layout = {"stoc": (13, 16), "relu": (2, 13), "evalmod": (16, 24),
              "ctos": (24, 28), "stoc_groups": 3}
    return CkksParams(log_n=log_n, logq=logq, logp=logp,
                      log_scale=30, h=192, sigma=3.2, boot_layout=layout,
                      q_explicit=q, p_explicit=p)


def _boot_layout(n_stoc: int, n_relu: int, n_mod: int, n_ctos: int) -> dict:
    """Stage → level (or half-open level range) of a bootstrappable chain."""
    relu = 3 + n_stoc
    return {
        "ecd": 1,
        "stoc": (2, 2 + n_stoc),
        "repack": 2 + n_stoc,
        "relu": (relu, relu + n_relu),
        "evalmod": (relu + n_relu, relu + n_relu + n_mod),
        "ctos": (relu + n_relu + n_mod, relu + n_relu + n_mod + n_ctos),
    }


def mini_boot_params(log_n: int = 10, n_relu: int = 2, n_mod: int = 9,
                     stoc_groups: int | None = None) -> CkksParams:
    """Small bootstrappable set for unit tests (scale 2^25, q0 2^55), with
    the level layout of ``boot_params``.  stoc_groups > 2 packs extra
    StoC matrices onto the top StoC level un-rescaled, as the production
    chain's "3 matrices on 2 levels" does."""
    n_stoc, n_ctos = 2, 3
    logq = (55, 35) + (35,) * n_stoc + (35,) + (25,) * n_relu \
        + (45,) * n_mod + (45,) * n_ctos
    layout = _boot_layout(n_stoc, n_relu, n_mod, n_ctos)
    if stoc_groups is not None:
        layout["stoc_groups"] = stoc_groups
    return CkksParams(log_n=log_n, logq=logq, logp=(56, 56, 56, 56),
                      log_scale=25, h=64, sigma=3.2, boot_layout=layout)


def tiny_params(log_n: int = 10, levels: int = 5) -> CkksParams:
    """Small non-bootstrappable set for fast unit tests."""
    logq = (50,) + (40,) * levels
    return CkksParams(log_n=log_n, logq=logq, logp=(55, 55), log_scale=30,
                      h=min(64, (1 << log_n) // 4), sigma=3.2)
