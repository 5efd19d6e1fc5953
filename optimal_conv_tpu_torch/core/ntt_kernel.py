"""K2/K3: the negacyclic NTT and its inverse on the card (``csrc/ntt.cu``).

Replaces ``optimal_conv_tpu/core/pallas_ntt.py`` (``_fwd_kernel``,
``_inv_kernel`` and their driver ``transform``).  The per-limb tables
the kernels read (the counterpart of ``PallasNttTables``) are the
``NttContext`` device tensors: ``q``, ``qinv``, ``n_inv`` as [L] and
the Montgomery twiddles ``psi_br`` / ``ipsi_br`` as [L, N], passed at
run time.  The plain versions are ``core.ntt._ntt_fwd`` / ``_ntt_inv``;
``NttContext.ntt`` / ``intt`` pick between them by device.

One transform is at most two launches, each one pass over device memory
(input read once, output written once, then read and written once more
in place), and no copy.  A pass keeps a tile in shared memory across a
group of consecutive stages, with 8 elements a thread in registers for
3 stages between two exchanges, and values lazily reduced until the
last store.  What bounds it on an H100 is the integer pipe, not the
bytes: at [128,1,6,N], logN = 16, the 32-bit instructions of 16 stages
of 64-bit Montgomery butterflies need about 0.9 ms at the card's peak,
the bytes 0.24 ms; ``PERF.md`` has both beside the measured times.
``plan`` works out the passes; ``csrc/ntt.cu`` has the schedule inside a
pass.

On an sp mesh (``parallel/coeffs.py``) a transform of a column shard is
K2/K3 at log_n − log2(sp) on the shard's twiddle table, plus
``ntt_cross_cuda``: one launch a stage that crosses shards, bytes-bound
(two halves read, one written).
"""

from __future__ import annotations

import functools

import torch

from ..utils import tracing
from . import cuda_lib

STATS_FWD = cuda_lib.KernelStats("ntt_fwd")
STATS_INV = cuda_lib.KernelStats("ntt_inv")
STATS_CROSS = cuda_lib.KernelStats("ntt_cross")

MAX_LOG_N = 17
SMEM_LIMIT = 232448        # bytes of shared memory one block can have
MAX_THREADS = 512
LOG_CHUNK = 8              # chunk pass of a two-pass transform: 256 points
# Sub-transforms a block of a two-pass transform: 4 columns or 4 chunks.
# Tiles of 2^(8+2) elements (128 threads, 8 KB) were the fastest of
# 2^8 .. 2^12 at [128,1,6,N] on an H100, and give a [2,N] transform 128
# blocks for the card's 132 SMs.
LOG_W = 2
# the largest ring that one block's shared memory holds: one launch
ONE_LAUNCH_MAX = (SMEM_LIMIT // 8).bit_length() - 1


def _pass(log_n: int, rows: int, k: int, log_stride: int, log_w: int,
          stages) -> dict:
    tile_log = k + log_w
    threads = min(MAX_THREADS, max(32, (1 << tile_log) // 8))
    return dict(k=k, log_stride=log_stride, log_w=log_w, threads=threads,
                smem=8 << tile_log, grid=rows << (log_n - tile_log),
                stages=stages)


@functools.lru_cache(maxsize=None)
def plan(log_n: int, rows: int, inverse: bool) -> tuple[dict, ...]:
    """The passes of one transform of `rows` rows, in execution order.

    Each pass is a dict of plain integers: ``k`` stages on sub-transforms
    of 2^k points whose points lie ``2^log_stride`` elements apart
    (0: a contiguous chunk; > 0: a column), ``2^log_w`` sub-transforms a
    block, ``threads``, ``smem`` bytes, ``grid`` blocks, and ``stages``,
    the (first, last) stage of the network it runs (stage s has 2^s
    twiddle blocks; the inverse runs them last to first).
    A ring of up to 2^ONE_LAUNCH_MAX fits one block: one pass.  Above,
    the stages with span >= 2^LOG_CHUNK are a column pass and the rest a
    chunk pass; forward runs columns first, the inverse chunks first.
    The result is cached and shared: read it, do not change it."""
    if not 1 <= log_n <= MAX_LOG_N:
        raise ValueError(f"ntt plan: log_n {log_n} outside 1..{MAX_LOG_N}")
    if rows < 1:
        raise ValueError("ntt plan: no rows")
    if log_n <= ONE_LAUNCH_MAX:
        return (_pass(log_n, rows, log_n, 0, 0, (0, log_n - 1)),)
    a = log_n - LOG_CHUNK
    cols = _pass(log_n, rows, a, LOG_CHUNK, LOG_W, (0, a - 1))
    chunks = _pass(log_n, rows, LOG_CHUNK, 0, LOG_W, (a, log_n - 1))
    return (chunks, cols) if inverse else (cols, chunks)


@functools.lru_cache(maxsize=None)
def _plan_ints(log_n: int, rows: int, inverse: bool) -> tuple[int, ...]:
    """(number of passes, then six integers a pass, padded to two passes)
    as ``optconv_ntt`` takes them."""
    passes = plan(log_n, rows, inverse)
    ints = [p[key] for p in passes for key in
            ("k", "log_stride", "log_w", "threads", "smem", "grid")]
    return (len(passes), *ints, *([0] * (12 - len(ints))))


def _row_strides(a: torch.Tensor) -> tuple[int, int] | None:
    """(batch stride, limb stride) in elements if the [..., l, N] tensor's
    rows have unit stride and its leading dims collapse to one stride."""
    if a.stride(-1) != 1:
        return None
    limb_stride = a.stride(-2)
    lead = [(s, st) for s, st in zip(a.shape[:-2], a.stride()[:-2]) if s != 1]
    if not lead:
        return 0, limb_stride
    for (_, st), (s_in, st_in) in zip(lead[:-1], lead[1:]):
        if st != s_in * st_in:
            return None
    return lead[-1][1], limb_stride


def ntt_cuda(a: torch.Tensor, row_limb: torch.Tensor, q: torch.Tensor,
             qinv: torch.Tensor, tw: torch.Tensor, n_inv: torch.Tensor,
             log_n: int, inverse: bool) -> torch.Tensor:
    """Transform the rows of a [..., l, N] int64 CUDA tensor out of place.

    row_limb: int32 [rows] global limb index of each row of the
    flattened [rows, N] view.  q, qinv, n_inv: int64 [L]; tw: int64
    [L, N] (psi_br forward, ipsi_br inverse), all Montgomery form.

    `a` is read in place through its strides when its rows have unit
    stride and its leading dims collapse to one batch stride (any slice
    of the limb dim of a contiguous tensor does); any other view is
    copied once with ``.contiguous()``."""
    t0 = tracing.stamp()
    n = 1 << log_n
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("ntt_cuda needs a CUDA tensor")
    if a.dtype != torch.int64 or a.dim() < 2 or a.shape[-1] != n:
        raise ValueError(f"ntt_cuda: int64 [..., l, {n}] expected, got "
                         f"{a.dtype} {tuple(a.shape)}")
    rows = a.numel() // n
    if row_limb.dtype != torch.int32 or row_limb.numel() != rows:
        raise ValueError("ntt_cuda: row_limb must be int32 with one entry "
                         "per row")
    for t in (row_limb, q, qinv, tw, n_inv):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("ntt_cuda: tables must be contiguous on "
                             f"{dev}")
    out = torch.empty(a.shape, dtype=torch.int64, device=dev)
    if rows == 0:
        return out
    ints = _plan_ints(log_n, rows, inverse)
    strides = _row_strides(a)
    if strides is None:
        a = a.contiguous()
        strides = _row_strides(a)
    lib = cuda_lib.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.optconv_ntt(a.data_ptr(), out.data_ptr(),
                               row_limb.data_ptr(), q.data_ptr(),
                               qinv.data_ptr(), tw.data_ptr(),
                               n_inv.data_ptr(), rows, a.shape[-2],
                               strides[0], strides[1], log_n, int(inverse),
                               *ints, stream)
    cuda_lib.check(code, "inverse NTT kernel" if inverse else "NTT kernel")
    (STATS_INV if inverse else STATS_FWD).launched(rows, t0)
    return out


def ntt_cross_cuda(mine: torch.Tensor, theirs: torch.Tensor,
                   row_limb: torch.Tensor, q: torch.Tensor, qinv: torch.Tensor,
                   w: torch.Tensor, upper: bool, inverse: bool) -> torch.Tensor:
    """One cross stage of an NTT split over column shards, on the card
    (``optconv_ntt_cross``): this rank's half `mine` and its partner's
    `theirs`, both [..., l, n] int64 canonical residues → this rank's
    output half (``core.ntt.ntt_cross_plain`` says which).

    row_limb: int32 [rows] global limb of each row of the flattened
    [rows, n] view; q, qinv, w: int64 [L] indexed by limb (w the stage's
    twiddle of each limb, Montgomery form).  A view that is not
    contiguous or not 16-byte aligned is copied once."""
    t0 = tracing.stamp()
    dev = mine.device
    if dev.type != "cuda":
        raise ValueError("ntt_cross_cuda needs a CUDA tensor")
    if (mine.dtype != torch.int64 or theirs.dtype != torch.int64
            or mine.shape != theirs.shape or mine.dim() < 2):
        raise ValueError("ntt_cross_cuda: two int64 [..., l, n] halves of one "
                         f"shape expected, got {mine.dtype} {tuple(mine.shape)}"
                         f" and {theirs.dtype} {tuple(theirs.shape)}")
    n = mine.shape[-1]
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n or log_n > MAX_LOG_N:
        raise ValueError(f"ntt_cross_cuda: width {n} is not a power of two in "
                         f"2 .. 2^{MAX_LOG_N}")
    rows = mine.numel() // n
    if row_limb.dtype != torch.int32 or row_limb.numel() != rows:
        raise ValueError("ntt_cross_cuda: row_limb must be int32 with one "
                         "entry per row")
    for t in (row_limb, q, qinv, w):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("ntt_cross_cuda: tables must be contiguous on "
                             f"{dev}")
    if theirs.device != dev:
        raise ValueError(f"ntt_cross_cuda: halves on {dev} and {theirs.device}")
    mine, theirs = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (mine.contiguous(), theirs.contiguous()))
    out = torch.empty(mine.shape, dtype=torch.int64, device=dev)
    if rows == 0:
        return out
    lib = cuda_lib.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.optconv_ntt_cross(mine.data_ptr(), theirs.data_ptr(),
                                     out.data_ptr(), row_limb.data_ptr(),
                                     q.data_ptr(), qinv.data_ptr(),
                                     w.data_ptr(), rows, log_n, int(upper),
                                     int(inverse), stream)
    cuda_lib.check(code, "NTT cross-stage kernel")
    STATS_CROSS.launched(rows, t0)
    return out
