"""The public half of a switching key, expanded from its seed.

Counterpart of ``CkksContext._uniform_mont_jax`` and
``_d1_regen_builder`` in ``optimal_conv_tpu/ckks/context.py``: uniform
residues [beta, |qp|, N] drawn from a 32-bit seed, read directly as the
Montgomery form of the key's uniform half a (uniform ↔ uniform), bit for
bit as the JAX package draws them.  That makes a key storable as d0 and
a seed (``ckks/context.SwitchingKey``), in either package.

The bits are those of ``jax.random.bits(PRNGKey(seed & 0xFFFFFFFF),
(4, beta, |qp|, N), uint32)`` with ``jax_threefry_partitionable`` on (the
JAX default since 0.5): word f of the flattened shape is ``x0 ^ x1`` of
Threefry-2x32 (20 rounds) applied to the counter (f >> 32, f & 0xFFFFFFFF)
under the key (0, seed & 0xFFFFFFFF).  Each residue takes 128 bits,
hi = w0·2^32 + w1 and lo = w2·2^32 + w3 from the four planes, and is
(hi·2^64 + lo) mod q = mont(hi, r2) + mont(lo, r1) mod q, so its bias
is at most 2^-66.  A pre-permuted hoisting key ("galh") carries the
NTT-domain permutation `perm` of φ_g⁻¹: element i of a row is drawn
at the counter of element perm[i], which is ``apply_galois_ntt`` of
the unpermuted draw.

``uniform_mont`` takes the plain version below on the CPU and the CUDA
kernel of ``csrc/d1_regen.cu`` (``d1_kernel.d1_regen_cuda``) on the
card.  The plain version runs in int64 with every word masked to 32 bits:
this PyTorch build has no uint32 add, shift or compare on the CPU.
"""

from __future__ import annotations

import torch

from . import d1_kernel
from . import modmath as mm

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors of 32-bit words; x0 and
    x1 are overwritten.  → (x0, x1)."""
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ KS_PARITY) & M32)
    x0.add_(ks[0]).bitwise_and_(M32)
    x1.add_(ks[1]).bitwise_and_(M32)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            # rotate left by r: x1 < 2^32, so x1 << r stays below 2^63
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_and_(M32).bitwise_or_(tmp)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def random_bits(seed: int, counters: torch.Tensor) -> torch.Tensor:
    """The 32-bit words (as int64) that ``jax.random.bits(PRNGKey(seed &
    0xFFFFFFFF), shape, uint32)`` puts at the flat indices `counters`
    (int64, ≥ 0)."""
    x0 = torch.bitwise_right_shift(counters, 32)
    x1 = counters & M32
    x0, x1 = threefry2x32(0, seed, x0, x1)
    return x0.bitwise_xor_(x1)


def uniform_mont_plain(seed: int, beta: int, q: torch.Tensor,
                       qinv: torch.Tensor, r2: torch.Tensor, r1: torch.Tensor,
                       n: int, perm: torch.Tensor | None = None,
                       rows: tuple[int, ...] | None = None,
                       nqp: int | None = None) -> torch.Tensor:
    """[beta, |qp|, n] uniform residues from `seed` on q's device; q, qinv,
    r2 = 2^128 mod q and r1 = 2^64 mod q are [|qp|, 1] columns.  With
    `perm` ([n] int64), element i of each row is drawn at perm[i].  With
    `rows`, the |qp| rows drawn are those global rows of a key of `nqp`
    limbs a digit, each at its counters there: a rank of a limb-sharded
    context draws its own rows of the whole key."""
    d1_kernel.STATS.plain_calls += 1
    dev = q.device
    nqp_local = q.shape[0]
    nqp_g = nqp_local if nqp is None else nqp
    ids = (torch.arange(nqp_local, dtype=torch.int64, device=dev)
           if rows is None else torch.tensor(rows, dtype=torch.int64,
                                             device=dev))
    grow = (torch.arange(beta, dtype=torch.int64, device=dev)[:, None] * nqp_g
            + ids).reshape(-1)
    col = (torch.arange(n, dtype=torch.int64, device=dev) if perm is None
           else perm.to(device=dev, dtype=torch.int64))
    base = grow[:, None] * n + col
    plane = beta * nqp_g * n
    w = [random_bits(seed, base + k * plane) for k in range(4)]
    shape = (beta, nqp_local, n)
    hi = (w[0].bitwise_left_shift_(32) | w[1]).view(shape)   # wraps like uint64
    lo = (w[2].bitwise_left_shift_(32) | w[3]).view(shape)
    return mm.add_mod_plain(mm.mont_mul_plain(hi, r2, q, qinv),
                      mm.mont_mul_plain(lo, r1, q, qinv), q)


def uniform_mont(seed: int, beta: int, q: torch.Tensor, qinv: torch.Tensor,
                 r2: torch.Tensor, r1: torch.Tensor, n: int,
                 perm: torch.Tensor | None = None,
                 rows: tuple[int, ...] | None = None,
                 nqp: int | None = None) -> torch.Tensor:
    """``uniform_mont_plain`` on the CPU; on the card one launch of the
    ``d1_regen`` kernel, or an error."""
    if q.device.type == "cpu":
        return uniform_mont_plain(seed, beta, q, qinv, r2, r1, n, perm, rows,
                                  nqp)
    return d1_kernel.d1_regen_cuda(seed, beta, q, qinv, r2, r1, n, perm, rows,
                                   nqp)
