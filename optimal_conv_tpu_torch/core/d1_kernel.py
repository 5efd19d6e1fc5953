"""The public key half d1 regenerated on the card (``csrc/d1_regen.cu``).

Replaces ``optimal_conv_tpu/ckks/context.py:_d1_regen_builder``, which on
the TPU is an XLA composite (threefry bits, two Montgomery products, an
add, optionally a gather), not a Pallas kernel.  The plain version is
``core.threefry.uniform_mont_plain``; ``core.threefry.uniform_mont``
picks between it and this wrapper by device.
"""

from __future__ import annotations

import functools

import torch

from ..utils import tracing
from . import cuda_lib

STATS = cuda_lib.KernelStats("d1_regen")
THREADS = 128
# A block draws up to MAX_ROWS_PER_BLOCK rows of THREADS coefficients,
# fewer when that would leave the card with less than BLOCKS_PER_SM
# blocks an SM: the level-27 key ([6, 33, N], 198 rows) takes 8 rows a
# block (25 x 512 blocks), the level-0 key ([1, 6, N]) one (6 x 512).
MAX_ROWS_PER_BLOCK = 8
BLOCKS_PER_SM = 16


def rows_per_block(rows: int, n: int, sms: int) -> int:
    """Rows a block draws: as many as keep BLOCKS_PER_SM blocks an SM,
    between 1 and MAX_ROWS_PER_BLOCK, and enough for a grid of at most
    65535 rows of blocks."""
    gx = -(-n // THREADS)
    rpb = max(1, min(MAX_ROWS_PER_BLOCK, rows * gx // (BLOCKS_PER_SM * sms)))
    return max(rpb, -(-rows // 65535))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ROW_IDS: dict = {}


def _row_ids(rows: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    key = (rows, dev)
    got = _ROW_IDS.get(key)
    if got is None:
        got = torch.tensor(rows, dtype=torch.int64, device=dev)
        _ROW_IDS[key] = got
    return got


def d1_regen_cuda(seed: int, beta: int, q: torch.Tensor, qinv: torch.Tensor,
                  r2: torch.Tensor, r1: torch.Tensor, n: int,
                  perm: torch.Tensor | None = None,
                  rows: tuple[int, ...] | None = None,
                  nqp: int | None = None) -> torch.Tensor:
    """[beta, |qp|, n] uniform residues of `seed` (its low 32 bits, as the
    JAX package's ``PRNGKey(seed & 0xFFFFFFFF)``) on the card, one launch.
    q, qinv, r2, r1: [|qp|, 1] (or [|qp|]) int64 CUDA tensors of one
    device; perm: None or [n] int64 on that device; rows: None (the whole
    key) or the |qp| global rows, each below `nqp`, of a key of `nqp`
    limbs a digit, drawn at their counters there.  Raises on anything
    else."""
    t0 = tracing.stamp()
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("d1_regen_cuda needs CUDA tensors")
    nqp_local = q.shape[0]
    tabs = [t.reshape(-1) for t in (q, qinv, r2, r1)]
    for t in tabs:
        if (t.device != dev or t.dtype != torch.int64 or t.numel() != nqp_local
                or not t.is_contiguous()):
            raise TypeError(f"d1_regen_cuda: contiguous int64 [{nqp_local}] tables on "
                            f"{dev} expected, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    if perm is not None and (perm.device != dev or perm.dtype != torch.int64
                             or tuple(perm.shape) != (n,)
                             or not perm.is_contiguous()):
        raise TypeError(f"d1_regen_cuda: perm must be a contiguous int64 [{n}] "
                        f"tensor on {dev}")
    if beta < 1 or n < 1:
        raise ValueError(f"d1_regen_cuda: beta {beta}, n {n}")
    nqp_g = nqp_local if nqp is None else nqp
    ids = None
    if rows is not None:
        if len(rows) != nqp_local or not all(0 <= r < nqp_g for r in rows):
            raise ValueError(f"d1_regen_cuda: rows {rows} for {nqp_local} "
                             f"limbs of a key of {nqp_g}")
        ids = _row_ids(tuple(rows), dev)
    elif nqp_g != nqp_local:
        raise ValueError(f"d1_regen_cuda: {nqp_local} limbs of a key of "
                         f"{nqp_g} need their rows")
    out = torch.empty((beta, nqp_local, n), dtype=torch.int64, device=dev)
    if nqp_local == 0:
        return out
    rpb = rows_per_block(beta * nqp_local, n, _sms(dev.index))
    with torch.cuda.device(dev):
        code = cuda_lib.lib().optconv_d1_regen(
            out.data_ptr(), *[t.data_ptr() for t in tabs],
            None if perm is None else perm.data_ptr(),
            None if ids is None else ids.data_ptr(), seed & 0xFFFFFFFF, beta,
            nqp_local, nqp_g, n, THREADS, rpb,
            torch._C._cuda_getCurrentRawStream(dev.index))
    cuda_lib.check(code, "d1_regen kernel")
    STATS.launched(beta * nqp_local, t0)
    return out
