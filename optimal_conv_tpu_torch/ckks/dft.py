"""Special-FFT stage factorization for homomorphic CoeffsToSlots/SlotsToCoeffs.

The canonical-embedding evaluation matrix V (slots z = V·u, u = c_lo +
i·c_hi, V[t,k] = w^{5^t·k}, w = e^{2πi/4n}) factors into log n radix-2
butterfly stages acting on a bit-reversed input — the classic CKKS
"special FFT".  Each stage touches only 3 diagonals {0, ±lenh}, so the
homomorphic DFT is a short product of BSGS linear transforms instead of
one dense matrix (SURVEY.md C14: GenCoeffsToSlotsMatrix /
GenSlotsToCoeffsMatrix in the fork's binary).

Crucially the factorization *omits the final bit-reversal*: slots come
out in bit-reversed coefficient order, which is exactly the index space
every repack generator of the reference lives in (rot_util.go uses
reverseBits everywhere) — see ops/repack.py.

Diagonal convention: M(x) = Σ_k d_k ⊙ rot_k(x), rot_k(x)[p] = x[p+k]
(left rotation).  Stages are built on the subring slot count n_sub and
tiled to the full slot view for sparse packings (periodic data ⇒
rotations and diagonals act per-period).
"""

from __future__ import annotations

import functools

import numpy as np


def _stage_diagonals(log_n: int, s: int, inverse: bool) -> dict[int, np.ndarray]:
    """Diagonals of decode-direction stage s (len = 2^{s+1}) on 2^log_n slots,
    or of its inverse."""
    n = 1 << log_n
    m = 4 * n
    len_ = 2 << s
    lenh = len_ // 2
    lenq = len_ * 4
    d0 = np.zeros(n, dtype=np.complex128)
    dp = np.zeros(n, dtype=np.complex128)   # diag +lenh
    dm = np.zeros(n, dtype=np.complex128)   # diag -lenh
    for i in range(0, n, len_):
        for j in range(lenh):
            tw = np.exp(2j * np.pi * (pow(5, j, lenq) * (m // lenq)) / m)
            if not inverse:
                # out[i+j]      =  x[i+j] + tw·x[i+j+lenh]
                # out[i+j+lenh] =  x[i+j] − tw·x[i+j+lenh]
                d0[i + j] = 1.0
                dp[i + j] = tw
                d0[i + j + lenh] = -tw
                dm[i + j + lenh] = 1.0
            else:
                # x[i+j]      = (out[i+j] + out[i+j+lenh]) / 2
                # x[i+j+lenh] = (out[i+j] − out[i+j+lenh]) / (2·tw)
                d0[i + j] = 0.5
                dp[i + j] = 0.5
                d0[i + j + lenh] = -0.5 / tw
                dm[i + j + lenh] = 0.5 / tw
    return {0: d0, lenh: dp, -lenh: dm}


@functools.lru_cache(maxsize=None)
def decode_stages(log_n: int) -> tuple:
    """Stages S_0..S_{log_n-1}: z = S_{last}∘…∘S_0 (u[brv])."""
    return tuple(_stage_diagonals(log_n, s, inverse=False)
                 for s in range(log_n))


@functools.lru_cache(maxsize=None)
def encode_stages(log_n: int) -> tuple:
    """Inverse stages, applied S_{last}^{-1} first: u[brv] = Π S_s^{-1} (z)."""
    return tuple(_stage_diagonals(log_n, s, inverse=True)
                 for s in reversed(range(log_n)))


def compose_diags(d2: dict[int, np.ndarray], d1: dict[int, np.ndarray],
                  n: int) -> dict[int, np.ndarray]:
    """Diagonals of M2∘M1 (apply M1 first) over n slots."""
    out: dict[int, np.ndarray] = {}
    for k2, v2 in d2.items():
        for k1, v1 in d1.items():
            k = (k1 + k2) % n
            term = v2 * np.roll(v1, -k2)
            if k in out:
                out[k] = out[k] + term
            else:
                out[k] = term.copy()
    return out


def group_stages(stages: list[dict[int, np.ndarray]], n_groups: int,
                 n: int) -> list[dict[int, np.ndarray]]:
    """Merge consecutive stages into n_groups matrices (depth↔width trade).

    Groups are balanced; each merged matrix has ≤ 2·2^(group size)−1
    diagonals, applied via one BSGS linear transform (one level each).
    """
    k, r = divmod(len(stages), n_groups)
    sizes = [k + (1 if i < r else 0) for i in range(n_groups)]
    out = []
    pos = 0
    for sz in sizes:
        acc = stages[pos]
        for s in stages[pos + 1: pos + sz]:
            acc = compose_diags(s, acc, n)
        out.append(acc)
        pos += sz
    return out


def apply_diags_np(diags: dict[int, np.ndarray], x: np.ndarray) -> np.ndarray:
    """Plaintext mirror of a diagonal linear transform."""
    out = np.zeros_like(x, dtype=np.complex128)
    for k, d in diags.items():
        out = out + d * np.roll(x, -k)
    return out


def tile(diags: dict[int, np.ndarray], reps: int) -> dict[int, np.ndarray]:
    """Tile n_sub-slot diagonals onto the full slot view (sparse packing)."""
    if reps == 1:
        return diags
    return {k: np.tile(d, reps) for k, d in diags.items()}
