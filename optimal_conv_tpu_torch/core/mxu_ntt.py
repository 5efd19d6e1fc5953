"""The four-step matrix NTT: modular matmuls on unsigned byte planes.

Counterpart of ``optimal_conv_tpu/core/mxu_ntt.py``, the JAX package's
default transform at logN ≥ 14 for calls over at most 12 limbs, where
the matrix unit is the TPU's MXU.  On the card the matrix unit is the
int8 tensor cores (``csrc/mxu_ntt.cu``, wrapper ``core/mxu_kernel.py``).
The transform is the same as the butterfly's, bit for bit (natural
order in, bit-reversed out, the ψ-twist merged): with A = 256 and
B = N/256, a row viewed as x[A, B],

    forward:  out = ((W1 ·q x) ⊙ T) ·q W2ᵀ
    inverse:  out = V1 ·q ((x ·q V2ᵀ) ⊙ Tᵢ)        (1/N folded into V1)

    W1[r, i1] = ψ^{B·i1·(2·brv_a(r)+1)}     [A, A]
    T [r, i2] = ψ^{i2·(2·brv_a(r)+1)}       [A, B]
    W2[c, i2] = ψ^{2A·i2·brv_b(c)}          [B, B]

and V2, Tᵢ, V1 the same with ψ⁻¹.  One modular matmul Σ_t W[m,t]·x[t,n]
mod q splits both operands into unsigned byte planes (nb of them, nb the
byte width of q), sums each byte-diagonal group g = p + s of the nb²
plane products, and recombines the 2·nb − 1 groups as three partial sums
at 2^0, 2^40 and 2^80, each below 2^60, reduced by three Montgomery
products.  It is exact: a group sums at most 8 × 255² × 256 < 2^27
products of bytes, so the planes need no −128 offset (the TPU's int8
MXU needed one; ``u8 × u8 → s32`` is a native tensor-core type), and a
float64 matmul of planes, the plain version here, is exact too.

``MxuNttTables`` holds the constant matrices as unsigned byte planes,
the middle twiddles and the recombination constants as tensors on one
device; ``mxu_fwd_plain`` / ``mxu_inv_plain`` are the plain versions.
``core.ntt.NttContext`` picks this route or the butterfly per call.
"""

from __future__ import annotations

import numpy as np
import torch

from . import modmath as mm
from . import mxu_kernel

A_LOG = 8                       # A = 256: the step-1 contraction length
PLANES = 8                      # bytes of a 64-bit word


def _brv(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    xx = x.copy()
    for _ in range(bits):
        out = (out << 1) | (xx & 1)
        xx >>= 1
    return out


def _redc(x: torch.Tensor, b_mont, q: int, qinv: int) -> torch.Tensor:
    """x·b·2^-64 mod q on host int64 tensors (b in Montgomery form), by
    the same arithmetic as ``modmath.mont_mul_plain`` but uncounted: the
    tables are built on the main path, where plain calls are checked."""
    b = torch.as_tensor(b_mont, dtype=torch.int64)
    return mm.mont_redc(mm.mul64_hi(x, b), x * b, torch.tensor(q),
                        torch.tensor(mm.as_i64(qinv)))


def byte_planes(mat: np.ndarray) -> np.ndarray:
    """Residues [.., M, T] (int64, < 2^62) → uint8 [.., 8, M, T]: plane p
    holds byte p of every entry, unsigned."""
    return np.stack([((mat >> (8 * p)) & 0xFF).astype(np.uint8)
                     for p in range(PLANES)], axis=-3)


def nbytes_of(q: int) -> int:
    """Byte planes a canonical residue mod q needs."""
    return max(1, (int(q).bit_length() + 7) // 8)


class MxuNttTables:
    """Per-limb constants of the four-step transform, as tensors on
    `device`, indexed by global limb.

    psi_br: the butterfly's host twiddles, [L, N] int64 Montgomery form
    in bit-reversed order (``core.ntt._tables_for_prime``), whose powers
    of ψ the matrices reuse, so both routes take the same root.

    Tensors: ``w1`` / ``iv1`` uint8 [L, 8, A, A] (W1 forward, V1 inverse
    with 1/N folded in), ``w2`` / ``iv2`` uint8 [L, 8, B, B] (W2 forward
    [c, i2], V2 inverse [i2, c]): unsigned byte planes, [m, t] with the
    contraction last.  ``t_mont`` / ``it_mont`` int64 [L, A, B]: T and Tᵢ
    in Montgomery form.  ``r1`` / ``c40`` / ``c80`` int64 [L]: 2^64 mod
    q, and 2^40, 2^80 in Montgomery form.  ``q`` / ``qinv`` int64 [L];
    ``nbytes`` a list and an int32 [L] tensor of byte widths."""

    def __init__(self, moduli, log_n: int, psi_br, device):
        if not 9 <= log_n <= 16:
            raise ValueError(f"the matrix NTT takes 9 <= log_n <= 16, got "
                             f"{log_n}")
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.A = A = 1 << A_LOG
        self.B = B = n // A
        self.moduli = [int(q) for q in moduli]
        self.device = dev = torch.device(device)
        L = len(self.moduli)
        psi_br = np.asarray(psi_br)
        if psi_br.shape != (L, n):
            raise ValueError(f"psi_br {psi_br.shape} for {L} limbs of {n}")
        lb = log_n - A_LOG
        odd_r = 2 * _brv(np.arange(A, dtype=np.int64), A_LOG) + 1      # [A]
        brv_c = _brv(np.arange(B, dtype=np.int64), lb)                  # [B]
        i1 = np.arange(A, dtype=np.int64)
        i2 = np.arange(B, dtype=np.int64)
        two_n = 2 * n
        # exponents of ψ, each an index into the 2N powers
        e_w1 = (B * np.outer(odd_r, i1)) % two_n                 # [r, i1]
        e_t = np.outer(odd_r, i2) % two_n                         # [r, i2]
        e_w2 = (2 * A * np.outer(brv_c, i2)) % two_n              # [c, i2]
        e_iv2 = (-2 * A * np.outer(i2, brv_c)) % two_n            # [i2, c]
        e_it = (-np.outer(odd_r, i2)) % two_n                     # [r, i2]
        e_iv1 = (-B * np.outer(i1, odd_r)) % two_n                # [i1, r]
        brv_n = _brv(np.arange(n, dtype=np.int64), log_n)

        w1 = np.empty((L, PLANES, A, A), dtype=np.uint8)
        iv1 = np.empty_like(w1)
        w2 = np.empty((L, PLANES, B, B), dtype=np.uint8)
        iv2 = np.empty_like(w2)
        t_mont = np.empty((L, A, B), dtype=np.int64)
        it_mont = np.empty_like(t_mont)
        for li, q in enumerate(self.moduli):
            qinv = mm.mont_qinv(q)
            # ψ^j (Montgomery form) for j < 2N: psi_br[k] = ψ^brv(k), and
            # ψ^(N+j) = −ψ^j
            half = psi_br[li][brv_n]
            pows_m = np.concatenate([half, q - half])
            pows = _redc(torch.from_numpy(pows_m), 1, q, qinv).numpy()
            w1[li] = byte_planes(pows[e_w1])
            w2[li] = byte_planes(pows[e_w2])
            iv2[li] = byte_planes(pows[e_iv2])
            ninv_m = pow(n, -1, q) * ((1 << 64) % q) % q
            iv1[li] = byte_planes(_redc(torch.from_numpy(pows[e_iv1]), ninv_m,
                                        q, qinv).numpy())
            t_mont[li] = pows_m[e_t]
            it_mont[li] = pows_m[e_it]

        def put(x):
            return torch.from_numpy(x).to(dev)

        self.w1, self.w2, self.iv2, self.iv1 = map(put, (w1, w2, iv2, iv1))
        self.t_mont, self.it_mont = put(t_mont), put(it_mont)
        r1 = [(1 << 64) % q for q in self.moduli]
        self.r1 = put(np.array(r1, dtype=np.int64))
        self.c40 = put(np.array([(1 << 40) * r % q
                                 for q, r in zip(self.moduli, r1)],
                                dtype=np.int64))
        self.c80 = put(np.array([(1 << 80) % q * r % q
                                 for q, r in zip(self.moduli, r1)],
                                dtype=np.int64))
        self.q = put(np.array(self.moduli, dtype=np.int64))
        self.qinv = put(np.array([mm.as_i64(mm.mont_qinv(q))
                                  for q in self.moduli], dtype=np.int64))
        self.nbytes = [nbytes_of(q) for q in self.moduli]
        self.nbytes_t = put(np.array(self.nbytes, dtype=np.int32))
        self._sel: dict = {}
        self._rows: dict = {}

    def planes_for(self, idx, nb: int | None = None) -> int:
        """Byte planes a call over the limbs `idx` runs: `nb` if given
        (every row at that width, as JAX's uniform planes; the plain
        versions only), else the widest limb's."""
        need = max(self.nbytes[i] for i in idx)
        if nb is None:
            return need
        if not need <= nb <= PLANES:
            raise ValueError(f"{nb} byte planes for limbs {tuple(idx)} that "
                             f"need {need}")
        return nb

    def row_limb(self, idx: tuple[int, ...], batch: int) -> torch.Tensor:
        """int32 [batch·l] on the tables' device: the limb of each row of
        a [batch, l, N] call on the limbs `idx`, for the kernel."""
        got = self._rows.get((idx, batch))
        if got is None:
            got = torch.tensor(list(idx) * batch, dtype=torch.int32,
                               device=self.q.device)
            self._rows[(idx, batch)] = got
        return got

    def select(self, limbs: tuple[int, ...], nb: int):
        """The tables of the limbs `limbs` at `nb` planes, for the plain
        versions: (w1, t_mont, w2, iv2, it_mont, iv1, q, qinv, r1, c40, c80)
        with the per-limb scalars shaped [l, 1, 1]."""
        key = (limbs, nb)
        got = self._sel.get(key)
        if got is None:
            sel = torch.tensor(limbs, dtype=torch.int64, device=self.device)

            def rows(t):
                return t.index_select(0, sel)

            got = (rows(self.w1)[:, :nb], rows(self.t_mont),
                   rows(self.w2)[:, :nb], rows(self.iv2)[:, :nb],
                   rows(self.it_mont), rows(self.iv1)[:, :nb],
                   *(rows(t)[:, None, None] for t in
                     (self.q, self.qinv, self.r1, self.c40, self.c80)))
            self._sel[key] = got
        return got

    def buckets(self, idx, nb: int | None = None):
        """[(positions into idx, planes)]: every row at `nb` planes, or
        the rows grouped by their limb's byte width."""
        if nb is not None:
            return [(tuple(range(len(idx))), self.planes_for(idx, nb))]
        widths = [self.nbytes[i] for i in idx]
        return [(tuple(p for p, w in enumerate(widths) if w == k), k)
                for k in sorted(set(widths), reverse=True)]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _part(groups) -> torch.Tensor:
    """Σ_k 2^{8k}·groups[k] (five groups or fewer: < 2^60)."""
    acc = groups[-1]
    for g in groups[-2::-1]:
        acc = (acc << 8) + g
    return acc


def mod_matmul_plain(w, x, q, qinv, r1, c40, c80) -> torch.Tensor:
    """Σ_t W[m,t]·x[t,n] mod q for canonical residues.

    w: uint8 [l, nb, M, T] byte planes; x: int64 [..., l, T, Nn]; the
    per-limb scalars [l, 1, 1].  Each byte-pair product is a float64
    matmul (exact: every sum is an integer below 2^27), summed into its
    diagonal group; the groups recombine as lo + 2^40·mid + 2^80·hi.
    → int64 [..., l, M, Nn], canonical."""
    nb = w.shape[1]
    wf = w.to(torch.float64)
    xs = [((x >> (8 * s)) & 0xFF).to(torch.float64) for s in range(nb)]
    groups = [None] * (2 * nb - 1)
    for p in range(nb):
        for s in range(nb):
            prod = torch.matmul(wf[:, p], xs[s])
            g = p + s
            groups[g] = prod if groups[g] is None else groups[g] + prod
    groups = [g.to(torch.int64) for g in groups]
    out = mm.mont_mul_plain(_part(groups[0:5]), r1, q, qinv)
    if len(groups) > 5:
        out = mm.add_mod_plain(out, mm.mont_mul_plain(_part(groups[5:10]), c40,
                                                      q, qinv), q)
    if len(groups) > 10:
        out = mm.add_mod_plain(out, mm.mont_mul_plain(_part(groups[10:15]),
                                                      c80, q, qinv), q)
    return out


def _transform_plain(a, idx, tabs: MxuNttTables, nb, inverse: bool):
    if a.shape[-1] != tabs.n or len(idx) != a.shape[-2]:
        raise ValueError(f"{tuple(a.shape)} rows for {len(idx)} limbs of "
                         f"{tabs.n}")
    A, B = tabs.A, tabs.B
    x = a.reshape(a.shape[:-1] + (A, B))                 # [..., l, A, B]
    out = torch.empty_like(x)
    for pos, k in tabs.buckets(idx, nb):
        sel = torch.tensor(pos, dtype=torch.int64, device=a.device)
        xk = x.index_select(-3, sel)
        (w1, t_m, w2, iv2, it_m, iv1, q, qinv, r1, c40, c80) = tabs.select(
            tuple(idx[p] for p in pos), k)
        consts = (q, qinv, r1, c40, c80)
        if inverse:
            # U[r, i2] = Σ_c V2[i2, c]·x[r, c]; ⊙ Tᵢ; out = V1 ·q U
            u = mod_matmul_plain(iv2, xk.transpose(-1, -2), *consts)
            u = mm.mont_mul_plain(u.transpose(-1, -2), it_m, q, qinv)
            res = mod_matmul_plain(iv1, u, *consts)
        else:
            # Y = W1 ·q x; ⊙ T; X[r, c] = Σ_i2 W2[c, i2]·Z[r, i2]
            y = mod_matmul_plain(w1, xk, *consts)
            z = mm.mont_mul_plain(y, t_m, q, qinv)
            res = mod_matmul_plain(w2, z.transpose(-1, -2),
                                   *consts).transpose(-1, -2)
        out.index_copy_(-3, sel, res)
    return out.reshape(a.shape)


def mxu_fwd_plain(a: torch.Tensor, idx, tabs: MxuNttTables,
                  nb: int | None = None) -> torch.Tensor:
    """Forward NTT of [..., l, N] (natural order → bit-reversed), rows
    on the limbs `idx`, by the plain matrix route: each row at its limb's
    byte width, or every row at `nb` planes."""
    mxu_kernel.STATS_FWD.plain_calls += 1
    return _transform_plain(a, tuple(idx), tabs, nb, inverse=False)


def mxu_inv_plain(a: torch.Tensor, idx, tabs: MxuNttTables,
                  nb: int | None = None) -> torch.Tensor:
    """Inverse NTT (bit-reversed → natural order, × 1/N), as
    ``mxu_fwd_plain``."""
    mxu_kernel.STATS_INV.plain_calls += 1
    return _transform_plain(a, tuple(idx), tabs, nb, inverse=True)
