"""CKKS encoders: coefficient packing and slot packing.

Counterpart of ``optimal_conv_tpu/ckks/encoding.py``.  Coefficient
encoding makes a real vector the polynomial's coefficients directly, so
a homomorphic convolution is one negacyclic product.  Slot encoding (the
canonical embedding) carries the values that ct×ct products, rotations
and polynomial evaluation act on slot by slot, and the masks and
diagonals of repacking and bootstrapping.

Encode and decode are client-side: rounding, the embedding and the
residue split run on the host in numpy float64/complex128 exactly as the
JAX package does them (``np.round(v * scale)``), so both packages encode
the same integers; the NTT and the Montgomery fold run on the context's
device.

Slot convention: slot t of a (sub)ring of degree m = 2n holds
p(w^{5^t}), w = e^{2πi/(4n)}.  Left rotation by r (slot t ← t + r) is
the Galois automorphism X → X^{5^r}; conjugation is X → X^{-1}.  For
log_slots < log_n − 1 the 2n coefficients sit at stride N/(2n) in the
big ring and the slot values repeat.

Each encode is a span ``encode`` (``utils/tracing.py``); the counter
``encode.bytes_up`` counts the bytes uploaded from pageable host memory
to a card: the residues of each encode, and the float64 weights and BN
scales that ``ops/conv.prep_ker`` uploads to encode a conv's kernel
plaintexts on the card (``encode_int_coeffs``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import modmath as mm
from ..utils import tracing
from .params import CkksParams, DeviceTables
from .types import Plaintext


@functools.lru_cache(maxsize=None)
def _rot_group(log_slots: int) -> np.ndarray:
    """[5^t mod 4n for t < n], n = 2^log_slots (read-only, shared)."""
    n = 1 << log_slots
    m = 4 * n
    out = np.empty(n, dtype=np.int64)
    acc = 1
    for t in range(n):
        out[t] = acc
        acc = acc * 5 % m
    out.setflags(write=False)
    return out


def slots_to_coeffs_np(z: np.ndarray) -> np.ndarray:
    """Inverse canonical embedding: complex[n] slots → real[2n] coefficients."""
    n = z.shape[-1]
    m = 4 * n
    e = _rot_group(int(np.log2(n)))
    buf = np.zeros(z.shape[:-1] + (m,), dtype=np.complex128)
    buf[..., e] = z
    buf[..., m - e] = np.conj(z)
    c = np.fft.fft(buf, axis=-1)[..., : 2 * n] / (2 * n)
    return np.ascontiguousarray(c.real)


def coeffs_to_slots_np(c: np.ndarray) -> np.ndarray:
    """Canonical embedding: real[2n] coefficients → complex[n] slot values."""
    two_n = c.shape[-1]
    n = two_n // 2
    m = 4 * n
    e = _rot_group(int(np.log2(n)))
    buf = np.zeros(c.shape[:-1] + (m,), dtype=np.complex128)
    buf[..., :two_n] = c
    v = np.fft.ifft(buf, axis=-1) * m
    return np.ascontiguousarray(v[..., e])


class Encoder:
    """rows(level, qp): the limbs of the plaintexts it makes (default all
    of Q_level, or of Q_level·P with qp); a limb-sharded context's
    encoder makes only its own rows."""

    def __init__(self, params: CkksParams, tables: DeviceTables, rows=None):
        self.params = params
        self.tables = tables
        self.rows = rows or (lambda level, qp: params.qp_idx(level) if qp
                             else params.q_idx(level))

    # ---- coefficient packing ---------------------------------------------

    @tracing.spanned("encode")
    def encode_coeffs(self, values: np.ndarray, scale: float, level: int,
                      mont: bool = True) -> Plaintext:
        """Real vector (len ≤ N, zero-padded) → NTT-domain plaintext at
        `level`/`scale`, in Montgomery form when `mont`."""
        p = self.params
        v = np.zeros(p.n, dtype=np.float64)
        v[: len(values)] = np.asarray(values, dtype=np.float64)
        return self._finalize(np.round(v * scale), level, scale, mont)

    def encode_int_coeffs(self, ints: torch.Tensor, pos: torch.Tensor,
                          level: int, out: torch.Tensor) -> None:
        """Rounded coefficients already on the device → plaintext polys,
        written into `out` [c, l, N] (the rows of `level`): polynomial i
        has the int64 coefficients ints[i] (|c| < 2^62) at the positions
        `pos` and zeros elsewhere.  NTT domain, Montgomery form; the
        residues equal those ``encode_coeffs`` makes of the same
        integers (``torch.remainder`` by a positive modulus is
        ``np.mod``)."""
        idx = self.rows(level, False)
        q = self.tables.ntt.tabs(idx)[0]
        out.zero_()
        out[:, :, pos] = torch.remainder(ints[:, None, :], q)
        out.copy_(self._ntt_form(out, idx, True))

    def decode_coeffs(self, res: np.ndarray, scale: float) -> np.ndarray:
        """[l+1, N] coeff-domain residues (host) → float64[N], CRT when l > 0."""
        p = self.params
        level = res.shape[0] - 1
        if level == 0:
            q = p.q_moduli[0]
            c = res[0].astype(np.int64)
            c = np.where(c > q // 2, c - q, c)
            return c.astype(np.float64) / scale
        cent = mm.residues_to_centered(res, p.q_moduli[: level + 1])
        return np.array([float(x) for x in cent]) / scale

    # ---- slot packing (canonical embedding) ------------------------------

    @tracing.spanned("encode")
    def encode_slots(self, z: np.ndarray, scale: float, level: int,
                     log_slots: int | None = None, mont: bool = True,
                     qp: bool = False) -> Plaintext:
        """Complex slot vector (len ≤ 2^log_slots, zero-padded) → plaintext.

        qp=True: residues over the extended basis Q_level·P, for products
        with the QP-basis accumulators of lazily key-switched rotations.
        Its first level+1 rows equal the qp=False encoding."""
        p = self.params
        ls = p.log_slots if log_slots is None else log_slots
        n = 1 << ls
        zz = np.zeros(n, dtype=np.complex128)
        zz[: len(z)] = np.asarray(z, dtype=np.complex128)
        c2n = slots_to_coeffs_np(zz)                 # [2n]
        gap = p.n // (2 * n)
        v = np.zeros(p.n, dtype=np.float64)
        v[::gap] = c2n
        return self._finalize(np.round(v * scale), level, scale, mont, qp)

    def decode_slots(self, res: np.ndarray, scale: float,
                     log_slots: int | None = None) -> np.ndarray:
        """[l+1, N] coeff-domain residues (host) → complex slots[2^log_slots]."""
        p = self.params
        ls = p.log_slots if log_slots is None else log_slots
        gap = p.n // (2 << ls)
        return coeffs_to_slots_np(self.decode_coeffs(res, scale)[::gap])

    # ---- helpers ---------------------------------------------------------

    def _finalize(self, ints: np.ndarray, level: int, scale: float,
                  mont: bool, qp: bool = False) -> Plaintext:
        """Rounded float64 coefficients → residues on the device, NTT
        domain, Montgomery form when `mont`."""
        p = self.params
        idx = self.rows(level, qp)
        mods = [p.moduli[i] for i in idx]
        if np.abs(ints).max() < 2**62:
            res = mm.centered_to_residues(ints.astype(np.int64), mods)
        else:
            big = np.array([int(x) for x in ints], dtype=object)
            res = mm.centered_to_residues(big, mods)
        ntt = self.tables.ntt
        if ntt.device.type != "cpu":
            tracing.count("encode.bytes_up", res.nbytes)
        poly = self._ntt_form(torch.from_numpy(res).to(ntt.device), idx, mont)
        return Plaintext(poly, level=level, scale=float(scale), is_mont=mont)

    def _ntt_form(self, res: torch.Tensor, idx, mont: bool) -> torch.Tensor:
        """[..., l, N] residues on the limbs `idx` → NTT domain, in
        Montgomery form when `mont`."""
        ntt = self.tables.ntt
        poly = ntt.ntt(res, idx)
        if mont:
            q, qinv, r2, _ = ntt.tabs(idx)
            poly = mm.to_mont(poly, q, qinv, r2)
        return poly
