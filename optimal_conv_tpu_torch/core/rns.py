"""RNS basis extension for hybrid key switching.

Counterpart of ``optimal_conv_tpu/core/rns.py`` (``BasisExtender``,
``DigitExtender``).  Fast basis extension from source primes {q_j} to
target primes {r_i}:

    y_j = x_j · (Q/q_j)^{-1} mod q_j
    v   = ⌊Σ_j f32(y_j) · f32(1/q_j)⌋          (the correction count)
    out_i = Σ_j y_j · (Q/q_j) − v·Q   mod r_i

v is computed in float32 as the JAX package does.  A ±1 change of v
only selects another representative x + u·Q, still a valid extension,
but to keep the bits equal the sum runs in the same order, j = 0…K−1,
each step one fused multiply-add, v ← fl32(f32(y_j)·f32(1/q_j) + v): that
is what XLA compiles the JAX package's sum to on the CPU.  The
difference decides v wherever the exact sum lies within a float32
rounding of an integer, which is every coefficient of a polynomial just
raised from q0 to the full chain (``bootstrap.mod_raise``): its integer
is tiny beside the digit's product of primes.

``BasisExtender.extend`` and ``DigitExtender.extend_digits`` dispatch on
the tensor's device, as ``modmath.mont_mul`` does: a CPU tensor runs the
plain chain below (``extend_plain``, ``extend_digits_plain``), a CUDA
tensor the hand-written kernel of ``csrc/rns_extend.cu``
(``rns_kernel.extend_cuda``: one launch, the same residues) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import modmath as mm
from . import rns_kernel


def _f32_count(y: torch.Tensor, inv_src) -> torch.Tensor:
    """v = ⌊Σ_j f32(y_j)·f32(1/q_j)⌋ over axis -2 of y, accumulated
    j = 0, 1, … in float32 with one rounding a step (a fused
    multiply-add).  inv_src[j] holds the float32 value f32(1/q_j) as a
    float or a float64 tensor that broadcasts against y[..., j, :].

    The product of two float32 values is exact in float64, so the sum
    there, rounded to float32, is the fused result (but for a double
    rounding once in about 2^29 steps); PyTorch has no fused
    multiply-add that rounds alike on the CPU and on the card."""
    yd = y.to(torch.float32).to(torch.float64)
    v = None
    for j, inv in enumerate(inv_src):
        t = yd[..., j, :] * inv
        v = (t if v is None else t + v.to(torch.float64)).to(torch.float32)
    return torch.floor(v).to(torch.int64)


class BasisExtender:
    """Extension from the source primes `src` to the target primes `dst`,
    with its constants as tensors on `device`."""

    def __init__(self, src, dst, device):
        self.src = [int(q) for q in src]
        self.dst = [int(r) for r in dst]
        k = len(self.src)
        big_q = 1
        for q in self.src:
            big_q *= q
        r64 = 1 << 64
        self.sq, self.sqinv = mm.limb_tables(self.src, device)[:2]   # [K, 1]
        self.dq, self.dqinv = mm.limb_tables(self.dst, device)[:2]   # [R, 1]
        self.qhat_inv_mont = torch.tensor(
            [pow((big_q // q) % q, -1, q) * r64 % q for q in self.src],
            dtype=torch.int64, device=device)[:, None]                 # [K, 1]
        # qhat_mont[j] = (Q/q_j)·2^64 mod r_i as an [R, 1] column
        self.qhat_mont = [torch.tensor(
            [(big_q // q) % r * r64 % r for r in self.dst],
            dtype=torch.int64, device=device)[:, None] for q in self.src]
        # qmod[i, v] = v·Q mod r_i for v = 0..K
        self.qmod_table = torch.tensor(
            [[v * big_q % r for v in range(k + 1)] for r in self.dst],
            dtype=torch.int64, device=device)                          # [R, K+1]
        self.inv_src = [float(np.float32(1.0 / q)) for q in self.src]
        # the kernel's description (rns_kernel.pack) and its tables by device
        self.spec = ((tuple(range(k)),), (tuple(self.src),), tuple(self.dst))
        self._cuda: dict = {}

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., K, N] coeff-domain residues mod src → [..., R, N]
        residues of (the same integer + u·Q_src) mod dst."""
        if x.device.type == "cpu":
            return self.extend_plain(x)
        return rns_kernel.extend_cuda(self, x, digit_axis=False)

    def extend_plain(self, x: torch.Tensor) -> torch.Tensor:
        """``extend`` as a chain of PyTorch operations, on any device."""
        rns_kernel.STATS.plain_calls += 1
        k = len(self.src)
        y = mm.mont_mul(x, self.qhat_inv_mont, self.sq, self.sqinv)
        v = _f32_count(y, self.inv_src).clamp_(0, k)             # [..., N]
        acc = None
        for j in range(k):
            t = mm.mont_mul(y[..., j:j + 1, :], self.qhat_mont[j], self.dq,
                            self.dqinv)                           # [..., R, N]
            acc = t if acc is None else mm.add_mod_plain(acc, t, self.dq)
        vq = self.qmod_table[:, v].movedim(0, -2)                 # [..., R, N]
        return mm.sub_mod_plain(acc, vq, self.dq)


class DigitExtender:
    """Extension of ALL key-switch digits of one level at once.

    digits: the Q-limb groups of the level (``CkksParams.digits``);
    dst: the global limbs of Q_level·P.  The per-digit tables are
    stacked to [beta, ...], the last digit padded to alpha limbs with
    zero constants (a padded row contributes exactly 0)."""

    def __init__(self, digits, dst, moduli, device):
        beta = len(digits)
        alpha = max(len(d) for d in digits)
        dst_mods = [int(moduli[i]) for i in dst]
        r64 = 1 << 64
        gather = np.zeros((beta, alpha), dtype=np.int64)
        sq = np.ones((beta, alpha), dtype=object)
        sqinv = np.full((beta, alpha), mm.mont_qinv(1), dtype=object)
        qhat_inv = np.zeros((beta, alpha), dtype=object)
        inv_src = np.zeros((beta, alpha), dtype=np.float32)
        qhat = np.zeros((alpha, beta, len(dst)), dtype=object)
        qmod = np.zeros((beta, len(dst), alpha + 1), dtype=object)
        for b, dig in enumerate(digits):
            src = [int(moduli[i]) for i in dig]
            big_q = 1
            for q in src:
                big_q *= q
            gather[b, :len(dig)] = dig
            for j, q in enumerate(src):
                sq[b, j] = q
                sqinv[b, j] = mm.mont_qinv(q)
                qhat_inv[b, j] = pow((big_q // q) % q, -1, q) * r64 % q
                inv_src[b, j] = np.float32(1.0 / q)
                for i, r in enumerate(dst_mods):
                    qhat[j, b, i] = (big_q // q) % r * r64 % r
            for i, r in enumerate(dst_mods):
                for v in range(alpha + 1):
                    qmod[b, i, v] = v * big_q % r

        def t(a):
            flat = [mm.as_i64(int(x)) for x in a.ravel()]
            return torch.tensor(flat, dtype=torch.int64,
                                device=device).reshape(a.shape)

        self.beta, self.alpha, self.R = beta, alpha, len(dst)
        self.gather = torch.from_numpy(gather).to(device)           # [beta, alpha]
        self.sq = t(sq)[..., None]                                  # [beta, alpha, 1]
        self.sqinv = t(sqinv)[..., None]
        self.qhat_inv_mont = t(qhat_inv)[..., None]
        self.qhat_mont = t(qhat)[..., None]                         # [alpha, beta, R, 1]
        self.qmod_table = t(qmod)                                   # [beta, R, alpha+1]
        # the float32 values, held as float64 for _f32_count
        self.inv_src = torch.from_numpy(inv_src.astype(np.float64)).to(device)  # [beta, alpha]
        self.dq, self.dqinv = (x[None] for x in
                               mm.limb_tables(dst_mods, device)[:2])  # [1, R, 1]
        # the kernel's description (rns_kernel.pack) and its tables by device
        self.spec = (tuple(tuple(d) for d in digits),
                     tuple(tuple(int(moduli[i]) for i in d) for d in digits),
                     tuple(dst_mods))
        self._cuda: dict = {}

    def extend_digits(self, c: torch.Tensor) -> torch.Tensor:
        """c: [..., L, N] coeff-domain residues → [..., beta, R, N]."""
        if c.device.type == "cpu":
            return self.extend_digits_plain(c)
        return rns_kernel.extend_cuda(self, c, digit_axis=True)

    def extend_digits_plain(self, c: torch.Tensor) -> torch.Tensor:
        """``extend_digits`` as a chain of PyTorch operations, on any
        device."""
        rns_kernel.STATS.plain_calls += 1
        x = c[..., self.gather, :]                         # [..., beta, alpha, N]
        y = mm.mont_mul(x, self.qhat_inv_mont, self.sq, self.sqinv)
        v = _f32_count(y, [self.inv_src[:, j:j + 1] for j in range(self.alpha)]
                       ).clamp_(0, self.alpha)                # [..., beta, N]
        acc = None
        for j in range(self.alpha):
            t = mm.mont_mul(y[..., j:j + 1, :], self.qhat_mont[j], self.dq,
                            self.dqinv)                     # [..., beta, R, N]
            acc = t if acc is None else mm.add_mod_plain(acc, t, self.dq)
        # v·Q mod r_i: gather from the [beta, R, alpha+1] table
        tab = self.qmod_table
        beta_i = torch.arange(self.beta, device=c.device)[:, None, None]
        r_i = torch.arange(self.R, device=c.device)[None, :, None]
        vq = tab[beta_i, r_i, v[..., :, None, :]]          # [..., beta, R, N]
        return mm.sub_mod_plain(acc, vq, self.dq)
