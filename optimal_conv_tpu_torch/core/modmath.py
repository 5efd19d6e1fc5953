"""Modular arithmetic for RNS-CKKS on int64 tensors.

Counterpart of ``optimal_conv_tpu/core/modmath.py``.  Residues are
**int64** tensors canonically reduced to ``[0, q)``: this PyTorch build
has no uint64 add, shift or compare on the CPU, and every modulus is
below 2^62 (``gen_ntt_primes``), so sums of two residues never wrap.
Montgomery constants that exceed 2^63 (``qinv = -q^{-1} mod 2^64``) are
stored as their two's-complement int64; products wrap mod 2^64 exactly
as uint64 products do, so the bits agree with the JAX package's.

``mont_mul`` and the chained ``mont_mul2`` dispatch on the tensors'
device: on the CPU they run the plain versions below (schoolbook 32-bit
halves, as the JAX package), on a CUDA tensor they launch the
hand-written kernel of ``csrc/mont_mul.cu``
(``mont_kernel.mont_mul_cuda``) or raise.  The additive operations
(``add_mod``, ``sub_mod``, ``neg_mod``, the stack sum ``sum_mod`` and the
centred correction ``centred_sub``) dispatch the same way, to their
``*_plain`` versions or to one launch of ``csrc/mod_add.cu``
(``mod_add_kernel``).

Host-side helpers (prime generation, primitive roots, Montgomery
constants, CRT) work on Python ints and numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mod_add_kernel, mont_kernel

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# plain Montgomery product (int64; arithmetic shifts are masked)
# ---------------------------------------------------------------------------

def mul64_hi(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the unsigned 128-bit product of int64 bit patterns.

    ``>>`` on int64 is arithmetic, so every shifted operand that may
    carry bit 63 (the halves of x and y, and the wrapped 32×32 partial
    products) is masked back to 32 bits."""
    xl = x & _M32
    xh = (x >> 32) & _M32
    yl = y & _M32
    yh = (y >> 32) & _M32
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    cross = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)
    return (hh + ((lh >> 32) & _M32) + ((hl >> 32) & _M32)
            + ((cross >> 32) & _M32))


def mont_redc(hi: torch.Tensor, lo: torch.Tensor, q: torch.Tensor,
              qinv: torch.Tensor) -> torch.Tensor:
    """REDC: t = hi·2^64 + lo < q·2^64 → t·2^-64 mod q in [0, q)."""
    m = lo * qinv                       # wraps mod 2^64
    r = hi + mul64_hi(m, q) + (lo != 0).to(torch.int64)      # < 2q
    return torch.where(r >= q, r - q, r)


def mont_mul_plain(a: torch.Tensor, b_mont: torch.Tensor, q: torch.Tensor,
                   qinv: torch.Tensor) -> torch.Tensor:
    """a·b·2^-64 mod q (b in Montgomery form), broadcasting like torch."""
    mont_kernel.STATS.plain_calls += 1
    return mont_redc(mul64_hi(a, b_mont), a * b_mont, q, qinv)


def mont_mul(a: torch.Tensor, b_mont: torch.Tensor, q: torch.Tensor,
             qinv: torch.Tensor) -> torch.Tensor:
    """a·b mod q where b_mont = b·2^64 mod q.  Result is standard-form.

    CPU tensors take the plain version; CUDA tensors the K1 kernel."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b_mont, q, qinv)
    return mont_kernel.mont_mul_cuda(a, b_mont, q, qinv)


def mont_mul2_plain(a: torch.Tensor, b_mont: torch.Tensor, c_mont: torch.Tensor,
                    q: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """(a·b·2^-64)·c·2^-64 mod q as two plain products."""
    return mont_mul_plain(mont_mul_plain(a, b_mont, q, qinv), c_mont, q, qinv)


def mont_mul2(a: torch.Tensor, b_mont: torch.Tensor, c_mont: torch.Tensor,
              q: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """mont_mul(mont_mul(a, b), c) with c constant along the last axis:
    on the card one pass of the K1 kernel, the intermediate product
    never written."""
    if a.device.type == "cpu":
        return mont_mul2_plain(a, b_mont, c_mont, q, qinv)
    return mont_kernel.mont_mul_cuda(a, b_mont, q, qinv, c_mont)


# ---------------------------------------------------------------------------
# add / sub / neg / sum / centred correction (inputs canonically reduced)
# ---------------------------------------------------------------------------

def add_mod_plain(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor
                  ) -> torch.Tensor:
    mod_add_kernel.STATS.plain_calls += 1
    s = a + b                                   # < 2^63 for q < 2^62
    return torch.where(s >= q, s - q, s)


def sub_mod_plain(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor
                  ) -> torch.Tensor:
    mod_add_kernel.STATS.plain_calls += 1
    return torch.where(a >= b, a - b, a + q - b)


def neg_mod_plain(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    mod_add_kernel.STATS.plain_calls += 1
    return torch.where(a == 0, a, q - a)


def sum_mod_plain(t: torch.Tensor, q: torch.Tensor, dim: int = 0
                  ) -> torch.Tensor:
    """Σ_i t.select(dim, i) mod q, added in order i = 0, 1, …"""
    acc = t.select(dim, 0)
    for i in range(1, t.shape[dim]):
        acc = add_mod_plain(acc, t.select(dim, i), q)
    return acc


def centred_sub_plain(a: torch.Tensor, b: torch.Tensor, half: int,
                      c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    # residues are int64 below 2^62: the signed compare is the unsigned one
    return torch.where(b > half, sub_mod_plain(a, c, q), a)


def add_mod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a + b mod q.  CPU tensors take the plain version; CUDA tensors the
    kernel of ``csrc/mod_add.cu``, as do the four below."""
    if a.device.type == "cpu":
        return add_mod_plain(a, b, q)
    return mod_add_kernel.add_mod_cuda(a, b, q)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a − b mod q."""
    if a.device.type == "cpu":
        return sub_mod_plain(a, b, q)
    return mod_add_kernel.sub_mod_cuda(a, b, q)


def neg_mod(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """−a mod q."""
    if a.device.type == "cpu":
        return neg_mod_plain(a, q)
    return mod_add_kernel.neg_mod_cuda(a, q)


def sum_mod(t: torch.Tensor, q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Σ_i t.select(dim, i) mod q over a stack's axis `dim` (not the last):
    on the card every term read once in one pass.  A single term is
    returned as the view it is."""
    if t.device.type == "cpu":
        return sum_mod_plain(t, q, dim)
    if t.shape[dim] == 1:
        return t.select(dim, 0)
    return mod_add_kernel.sum_mod_cuda(t, q, dim)


def centred_sub(a: torch.Tensor, b: torch.Tensor, half: int, c: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """a − c mod q where b > half, else a: the centred correction of a
    rescale or a ModRaise, with b [..., 1, N] the top limb's coefficients
    (half = q_top // 2) and c = q_top mod q a column."""
    if a.device.type == "cpu":
        return centred_sub_plain(a, b, half, c, q)
    return mod_add_kernel.centred_sub_cuda(a, b, half, c, q)


def mul_mod(a, b, q, qinv, r2):
    """a·b mod q for two standard-form operands (r2 = 2^128 mod q)."""
    return mont_mul2(a, b, r2, q, qinv)


def to_mont(a, q, qinv, r2):
    """a → a·2^64 mod q."""
    return mont_mul(a, r2, q, qinv)


def from_mont(a_mont, q, qinv):
    """a·2^64 mod q → a (multiply by the Montgomery form of 1, i.e. 1)."""
    return mont_mul(a_mont, torch.ones_like(q), q, qinv)


# ---------------------------------------------------------------------------
# host-side constants (Python ints)
# ---------------------------------------------------------------------------

def as_i64(v: int) -> int:
    """Unsigned 64-bit value → the int64 with the same bits."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def mont_qinv(q: int) -> int:
    """-q^{-1} mod 2^64 (unsigned)."""
    return (-pow(q, -1, 1 << 64)) & _M64


def mont_r2(q: int) -> int:
    """2^128 mod q."""
    return (1 << 128) % q


def limb_tables(moduli, device) -> tuple[torch.Tensor, ...]:
    """(q, qinv, r2, r1) as [L, 1] int64 tensors on `device`."""
    mods = [int(q) for q in moduli]
    cols = ([q for q in mods], [as_i64(mont_qinv(q)) for q in mods],
            [mont_r2(q) for q in mods], [(1 << 64) % q for q in mods])
    return tuple(torch.tensor(c, dtype=torch.int64, device=device)[:, None]
                 for c in cols)


def _miller_rabin(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(log_n: int, bit_sizes: list[int]) -> list[int]:
    """NTT-friendly primes q ≡ 1 (mod 2N), one per requested bit size,
    scanned alternately below/above 2^size (closest first)."""
    two_n = 1 << (log_n + 1)
    taken: set[int] = set()
    out = []
    for size in bit_sizes:
        base = 1 << size
        k = 0
        found = None
        while found is None:
            k += 1
            for cand in (base - k * two_n + 1, base + k * two_n + 1):
                if cand in taken or cand.bit_length() > 62:
                    continue
                if _miller_rabin(cand):
                    found = cand
                    break
        taken.add(found)
        out.append(found)
    return out


def _factorize(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q."""
    factors = _factorize(q - 1)
    for g in range(2, q):
        if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {q}")


def root_of_unity(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod q (order | q-1)."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide {q} - 1")
    psi = pow(primitive_root(q), (q - 1) // order, q)
    assert pow(psi, order, q) == 1 and pow(psi, order // 2, q) != 1
    return psi


def centered_to_residues(coeffs: np.ndarray, moduli) -> np.ndarray:
    """Signed integer coefficients (int64 or object array, length N) →
    int64 residues [L, N] (host side)."""
    n = coeffs.shape[-1]
    out = np.empty((len(moduli), n), dtype=np.int64)
    is_object = coeffs.dtype == object
    for i, q in enumerate(moduli):
        if is_object:
            out[i] = np.array([int(c) % q for c in coeffs], dtype=np.int64)
        else:
            out[i] = np.mod(coeffs, q)
    return out


def residues_to_centered(res: np.ndarray, moduli) -> np.ndarray:
    """Residues [L, N] → centered big-int coefficients (object array),
    by CRT with Python ints."""
    L, n = res.shape
    mods = [int(q) for q in moduli[:L]]
    big_q = 1
    for q in mods:
        big_q *= q
    acc = np.zeros(n, dtype=object)
    for i, q in enumerate(mods):
        qhat = big_q // q
        inv = pow(qhat % q, -1, q)
        acc += np.asarray(res[i]).astype(object) * ((qhat * inv) % big_q)
    acc %= big_q
    return np.where(acc > big_q // 2, acc - big_q, acc)
