"""Negacyclic NTT/iNTT over RNS limb tensors, plus Galois automorphisms.

Counterpart of ``optimal_conv_tpu/core/ntt.py``.  Polynomials are
``[..., l, N]`` int64 tensors (limb-major).  The forward transform takes
natural-order coefficients to **bit-reversed** evaluation order with the
ψ-twist merged into the twiddles; position ``j`` of the output holds
``p(ψ^{2·brv(j)+1})``, so a Galois automorphism ``X → X^g`` is a pure
gather in the NTT domain.

``NttContext`` owns the per-limb tables as tensors on its device, built
once per modulus chain and passed to the kernels at run time.
``ntt``/``intt`` pick a route per call, then dispatch on the data's
device: the butterfly (the plain reshape-stage network below on the CPU,
the K2/K3 kernels of ``ntt_kernel`` on CUDA) or the four-step matrix
transform (``mxu_ntt``'s plain version on the CPU, ``mxu_kernel`` on
CUDA).  Both give the same residues.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modmath as mm
from . import mxu_kernel, mxu_ntt, ntt_kernel

BACKENDS = ("butterfly", "mxu", "auto")
# "auto" sends a transform over at most this many limbs to the matrix
# route at logN >= MXU_MIN_LOG_N, as the JAX package's default does
# (its OPTCONV_MXU_MAX_LIMBS, here a constant).  Both thresholds are the
# TPU's tuning: on an H100 the matrix route is slower than K2/K3 at every
# width (PERF.md), so "auto" is there for parity with the JAX package,
# not for speed.
MXU_MAX_LIMBS = 12
MXU_MIN_LOG_N = 14


def bit_reverse_perm(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reversal of i at width log2(n)."""
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


def _mont_pow_table(base: int, q: int, n: int) -> np.ndarray:
    """[base^j · 2^64 mod q for j < n] (Montgomery form), host side."""
    out = np.empty(n, dtype=np.int64)
    acc = (1 << 64) % q
    for i in range(n):
        out[i] = acc
        acc = acc * base % q
    return out


@functools.lru_cache(maxsize=None)
def _tables_for_prime(q: int, log_n: int):
    """(psi_br_mont[N], ipsi_br_mont[N], n_inv_mont) for one prime, with
    psi the same primitive 2N-th root as the JAX package picks."""
    n = 1 << log_n
    psi = mm.root_of_unity(q, 2 * n)
    br = bit_reverse_perm(n)
    psi_br = _mont_pow_table(psi, q, n)[br]
    ipsi_br = _mont_pow_table(pow(psi, -1, q), q, n)[br]
    psi_br.setflags(write=False)
    ipsi_br.setflags(write=False)
    n_inv_m = pow(n, -1, q) * ((1 << 64) % q) % q
    return psi_br, ipsi_br, n_inv_m


class NttContext:
    """NTT tables for a list of RNS moduli at ring degree 2^log_n, as
    tensors on `device`, indexed by global limb index.

    backend: the route of every transform call, the counterpart of the
    JAX package's ``OPTCONV_NTT_BACKEND``: "butterfly" (its xla,
    xla_loop and pallas schedules, one network; K2/K3 on the card),
    "mxu" (the four-step matrix transform) or "auto" (JAX's default
    rule, ``resolved_backend``).  The matrix route's tables are built at
    its first call."""

    def __init__(self, moduli, log_n: int, device: torch.device,
                 backend: str = "butterfly"):
        if backend not in BACKENDS:
            raise ValueError(f"ntt backend {backend!r}: use "
                             + "|".join(BACKENDS))
        self.backend = backend
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = [int(q) for q in moduli]
        self.device = torch.device(device)
        L = len(self.moduli)
        psi = np.empty((L, self.n), dtype=np.int64)
        ipsi = np.empty((L, self.n), dtype=np.int64)
        ninv = np.empty(L, dtype=np.int64)
        for i, q in enumerate(self.moduli):
            psi[i], ipsi[i], ninv[i] = _tables_for_prime(q, log_n)
        dev = self.device
        self.psi_br = torch.from_numpy(psi).to(dev)            # [L, N]
        self.ipsi_br = torch.from_numpy(ipsi).to(dev)          # [L, N]
        self.n_inv = torch.from_numpy(ninv).to(dev)            # [L]
        self._all = mm.limb_tables(self.moduli, dev)  # q, qinv, r2, r1: [L, 1]
        self.q_vec = self._all[0][:, 0].contiguous()           # [L]
        self.qinv_vec = self._all[1][:, 0].contiguous()
        self._tabs: dict = {}
        self._plain: dict = {}
        self._rows: dict = {}
        self._mxu_tabs = None

    def resolved_backend(self, idx) -> str:
        """The route of one transform call over the limbs `idx`: the
        JAX package's ``NttContext._resolved_backend`` with its butterfly
        schedules as one.  "auto": the butterfly below logN 14, the matrix
        route for at most MXU_MAX_LIMBS limbs, the butterfly above."""
        if self.backend != "auto":
            return self.backend
        if self.log_n < MXU_MIN_LOG_N or len(idx) > MXU_MAX_LIMBS:
            return "butterfly"
        return "mxu"

    def mxu_tables(self) -> mxu_ntt.MxuNttTables:
        """The matrix route's tables on this context's device, built at
        the first call (as the JAX package's ``NttContext._mxu``)."""
        if self._mxu_tabs is None:
            psi = np.stack([_tables_for_prime(q, self.log_n)[0]
                            for q in self.moduli])
            self._mxu_tabs = mxu_ntt.MxuNttTables(self.moduli, self.log_n,
                                                  psi, self.device)
        return self._mxu_tabs

    def _select(self, idx: tuple[int, ...]) -> torch.Tensor:
        return torch.tensor(list(idx), dtype=torch.int64, device=self.device)

    def tabs(self, idx: tuple[int, ...]):
        """(q, qinv, r2, r1) as [l, 1] tensors for the limbs `idx`."""
        got = self._tabs.get(idx)
        if got is None:
            sel = self._select(idx)
            got = tuple(t.index_select(0, sel) for t in self._all)
            self._tabs[idx] = got
        return got

    def plain_tabs(self, idx: tuple[int, ...]):
        """(psi_br [l, N], ipsi_br [l, N], n_inv [l, 1]) for the plain
        versions on the limbs `idx`."""
        got = self._plain.get(idx)
        if got is None:
            sel = self._select(idx)
            got = (self.psi_br.index_select(0, sel),
                   self.ipsi_br.index_select(0, sel),
                   self.n_inv.index_select(0, sel)[:, None])
            self._plain[idx] = got
        return got

    def _row_limb(self, idx, batch: int) -> torch.Tensor:
        key = (idx, batch)
        got = self._rows.get(key)
        if got is None:
            got = torch.tensor(list(idx) * batch, dtype=torch.int32,
                               device=self.device)
            self._rows[key] = got
        return got

    def _transform(self, a: torch.Tensor, idx, inverse: bool) -> torch.Tensor:
        idx = tuple(range(a.shape[-2])) if idx is None else tuple(idx)
        if len(idx) != a.shape[-2]:
            raise ValueError(f"{len(idx)} limb indices for {a.shape[-2]} rows")
        if self.resolved_backend(idx) == "mxu":
            return self._mxu_transform(a, idx, inverse)
        if a.device.type == "cpu":
            q, qinv = self.tabs(idx)[:2]
            psi, ipsi, ninv = self.plain_tabs(idx)
            if inverse:
                return _ntt_inv(a, ipsi, ninv, q, qinv, self.log_n)
            return _ntt_fwd(a, psi, q, qinv, self.log_n)
        batch = a.numel() // (self.n * len(idx)) if a.numel() else 0
        return ntt_kernel.ntt_cuda(
            a, self._row_limb(idx, batch), self.q_vec, self.qinv_vec,
            self.ipsi_br if inverse else self.psi_br, self.n_inv, self.log_n,
            inverse)

    def _mxu_transform(self, a: torch.Tensor, idx, inverse: bool):
        tabs = self.mxu_tables()
        if a.device.type == "cpu":
            plain = mxu_ntt.mxu_inv_plain if inverse else mxu_ntt.mxu_fwd_plain
            return plain(a, idx, tabs)
        return mxu_kernel.mxu_cuda(a, idx, tabs, inverse)

    def ntt(self, a: torch.Tensor, idx=None) -> torch.Tensor:
        """Forward negacyclic NTT: [..., l, N] natural order → bit-rev.
        idx: the global limbs of the l rows (default the first l)."""
        return self._transform(a, idx, inverse=False)

    def intt(self, a: torch.Tensor, idx=None) -> torch.Tensor:
        """Inverse negacyclic NTT: [..., l, N] bit-rev → natural order."""
        return self._transform(a, idx, inverse=True)


# ---------------------------------------------------------------------------
# plain versions: the in-place network as reshape stages
# ---------------------------------------------------------------------------

def _ntt_fwd(a, psi_br, q, qinv, log_n):
    ntt_kernel.STATS_FWD.plain_calls += 1
    n = 1 << log_n
    shape = a.shape
    lead = tuple(shape[:-1])
    q3, qi3 = q[..., None], qinv[..., None]
    m, t = 1, n
    while m < n:
        t //= 2
        s = psi_br[..., m:2 * m, None]                  # [l, m, 1]
        blk = a.reshape(lead + (m, 2, t))
        u = blk[..., 0, :]
        v = mm.mont_mul_plain(blk[..., 1, :], s, q3, qi3)
        a = torch.stack([mm.add_mod_plain(u, v, q3),
                         mm.sub_mod_plain(u, v, q3)], dim=-2).reshape(shape)
        m *= 2
    return a


def _ntt_inv(a, ipsi_br, n_inv, q, qinv, log_n):
    ntt_kernel.STATS_INV.plain_calls += 1
    n = 1 << log_n
    shape = a.shape
    lead = tuple(shape[:-1])
    q3, qi3 = q[..., None], qinv[..., None]
    t, m = 1, n
    while m > 1:
        h = m // 2
        s = ipsi_br[..., h:2 * h, None]                 # [l, h, 1]
        blk = a.reshape(lead + (h, 2, t))
        u = blk[..., 0, :]
        v = blk[..., 1, :]
        a = torch.stack([mm.add_mod_plain(u, v, q3),
                         mm.mont_mul_plain(mm.sub_mod_plain(u, v, q3), s, q3,
                                           qi3)], dim=-2).reshape(shape)
        t *= 2
        m = h
    return mm.mont_mul_plain(a, n_inv, q, qinv)


def ntt_cross_plain(mine, theirs, w, q, qinv, upper: bool, inverse: bool):
    """One cross stage of a transform split over column shards: this
    rank's half of the stage's butterflies and its partner's, [..., l, n]
    each, w / q / qinv [l, 1] → this rank's output half.  The forward
    stage's lower rank keeps u + w·v and the upper u − w·v; the inverse
    stage's lower keeps u + v and the upper (u − v)·w (u the lower half,
    v the upper).  The card's version is ``ntt_kernel.ntt_cross_cuda``."""
    ntt_kernel.STATS_CROSS.plain_calls += 1
    if not inverse:
        if upper:
            return mm.sub_mod_plain(theirs, mm.mont_mul_plain(mine, w, q, qinv),
                                    q)
        return mm.add_mod_plain(mine, mm.mont_mul_plain(theirs, w, q, qinv), q)
    if upper:
        return mm.mont_mul_plain(mm.sub_mod_plain(theirs, mine, q), w, q, qinv)
    return mm.add_mod_plain(mine, theirs, q)


# ---------------------------------------------------------------------------
# Galois automorphisms  X → X^g  (g odd, mod 2N)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def galois_perm_ntt(log_n: int, g: int) -> np.ndarray:
    """Permutation π with (φ_g a)^[j] = a^[π(j)] for NTT-domain data."""
    n = 1 << log_n
    e = 2 * bit_reverse_perm(n) + 1              # position → exponent
    pos_of = np.empty(2 * n, dtype=np.int64)
    pos_of[e] = np.arange(n)
    out = pos_of[(e * (g % (2 * n))) % (2 * n)]
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def galois_perm_coeff(log_n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, flip) with (φ_g a)[k] = ±a[src[k]] for coefficient data."""
    n = 1 << log_n
    i = np.arange(n, dtype=np.int64)
    dest = (i * (g % (2 * n))) % (2 * n)
    sign_flip = dest >= n
    dest = np.where(sign_flip, dest - n, dest)
    src = np.empty(n, dtype=np.int64)
    flip = np.empty(n, dtype=bool)
    src[dest] = i
    flip[dest] = sign_flip
    src.setflags(write=False)
    flip.setflags(write=False)
    return src, flip


def apply_galois_ntt(a: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Automorphism on NTT-domain [..., L, N] data: a gather."""
    return a.index_select(-1, perm)


def apply_galois_coeff(a: torch.Tensor, src: torch.Tensor, flip: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    g = a.index_select(-1, src)
    return torch.where(flip, mm.neg_mod(g, q), g)


def rot_to_galois(k: int, log_n: int) -> int:
    """Slot rotation by k ↔ Galois element 5^k mod 2N."""
    return pow(5, k, 1 << (log_n + 1))
