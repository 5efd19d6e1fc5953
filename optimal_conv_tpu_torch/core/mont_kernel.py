"""K1: the elementwise Montgomery product on the card (``csrc/mont_mul.cu``).

Replaces ``optimal_conv_tpu/core/pallas_mod.py:mont_mul_pallas``.  The
wrapper takes int64 tensors that broadcast against each other the way
``torch`` broadcasts, with ``q``/``qinv`` (and the chained factor ``c``)
constant along the last axis.  It describes each operand to the kernel
by its row strides (a stride of 0 is a broadcast row dim) and its column
stride (0 for a per-row scalar such as a Montgomery constant), so
broadcast operands are read in place and never materialised.

The description is a ``Plan``: a pure function of the operands' shapes,
strides and 16-byte alignment (``plan``), cached, so a call site pays
for it once.  It holds the merged row dims, whether the kernel may use
16-byte accesses, the block size and the grid, and the ctypes structure
the C entry point reads.

The plain versions are ``core.modmath.mont_mul_plain`` and
``mont_mul2_plain``; ``core.modmath.mont_mul`` and ``mont_mul2`` pick
between them and this wrapper by device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils import tracing
from . import cuda_lib

STATS = cuda_lib.KernelStats("mont_mul")
MAX_DIMS = 4
N_OPS = 5                      # a, b, q, qinv, c

# One block is THREADS threads of PER_THREAD units each: a unit is a
# 16-byte vector of two elements on the vector path, one element on the
# scalar.  Small tiles won on the H100 (utils/mont_bench.py --ab; PERF.md
# has the tables): 128 x 2 beat 256 x 4 by 10% and 256 x 8 by 30% at
# [1,2,N] x [256,2,N], and [1,N] still gives 128 blocks.  PER_THREAD is
# kPerThread of csrc/mont_mul.cu.
THREADS = 128
PER_THREAD = 2


class Launch(ctypes.Structure):
    """``OptconvMontLaunch`` of csrc/mont_mul.cu, field for field."""
    _fields_ = [("n", ctypes.c_longlong), ("rows", ctypes.c_longlong),
                ("size", ctypes.c_longlong * MAX_DIMS),
                ("stride", (ctypes.c_longlong * MAX_DIMS) * N_OPS)] + [
        (name, ctypes.c_int) for name in
        ("nd", "a_col", "b_col", "chained", "vec", "threads", "gx", "gy",
         "gz")]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call reaches the kernel.  `dims` are the merged row dims,
    outermost first, each (size, (a, b, q, qinv, c) element strides);
    `collapse` says the row dims did not merge into MAX_DIMS, so the
    wrapper must first materialise the broadcast operands."""
    shape: tuple
    rows: int
    n: int
    dims: tuple
    a_col: int
    b_col: int
    chained: bool
    vec: bool
    threads: int
    grid: tuple
    collapse: bool
    launch: Launch = dataclasses.field(compare=False, repr=False)


def _merge_row_dims(shape, strides):
    """Row dims of `shape` (all but the last) with each operand's element
    strides, size-1 dims dropped and contiguous neighbours merged."""
    merged: list[tuple[int, tuple]] = []
    for d in range(len(shape) - 1):
        size = shape[d]
        if size == 1:
            continue
        st = tuple(s[d] for s in strides)
        if merged:
            psize, pst = merged[-1]
            if all(ps == s * size for ps, s in zip(pst, st)):
                merged[-1] = (psize * size, st)
                continue
        merged.append((size, st))
    return tuple(merged)


def _broadcast_strides(shape, op_shape, op_stride):
    """Element strides of an operand along every dim of `shape`: 0 where
    it is broadcast (a missing or size-1 dim)."""
    lead = len(shape) - len(op_shape)
    return tuple(0 if d < lead or op_shape[d - lead] == 1 else
                 op_stride[d - lead] for d in range(len(shape)))


def describe(a, b, q, qinv, c=None):
    """The cache key of a call: each operand's (shape, strides), and
    whether a and b start on a 16-byte boundary."""
    ops = (a, b, q, qinv) if c is None else (a, b, q, qinv, c)
    return (tuple((tuple(t.shape), t.stride()) for t in ops),
            (a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0))


@functools.lru_cache(maxsize=4096)
def plan(layout, aligned) -> Plan:
    """The launch plan of one call site, from `describe`'s key.  Pure
    integer arithmetic: no tensor, no device."""
    chained = len(layout) == N_OPS
    shape = tuple(torch.broadcast_shapes(*[s for s, _ in layout]))
    if not shape:
        raise ValueError("mont_mul_cuda needs at least one axis")
    for s, _ in layout[2:]:
        if s[-1:] not in ((), (1,)):
            raise ValueError("q, qinv and c must be constant along the last axis")
    n = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    strides = [_broadcast_strides(shape, s, st) for s, st in layout]
    if not chained:
        strides.append((0,) * len(shape))
    for st in strides[:2]:
        if n > 1 and st[-1] not in (0, 1):
            raise ValueError("a and b must be contiguous along the last axis")
    a_col, b_col = (int(n > 1 and st[-1] == 1) for st in strides[:2])
    dims = _merge_row_dims(shape, strides)
    collapse = len(dims) > MAX_DIMS
    if rows * n == 0 or collapse:
        return Plan(shape, rows, n, dims, a_col, b_col, chained, False, 0,
                    (0, 0, 0), collapse, Launch())
    if rows >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"mont_mul_cuda: {rows} rows of {n} exceed the "
                         "kernel's 32-bit row and column indices")

    def in_16_bytes(k, col):
        return not col or (aligned[k] and all(st[k] % 2 == 0 for _, st in dims))

    vec = (n % 2 == 0 and in_16_bytes(0, a_col) and in_16_bytes(1, b_col))
    units = n // 2 if vec else n
    gx = -(-units // (THREADS * PER_THREAD))
    gy = min(rows, 32768)
    gz = -(-rows // gy)
    launch = Launch(n=n, rows=rows, nd=len(dims), a_col=a_col, b_col=b_col,
                    chained=chained, vec=vec, threads=THREADS, gx=gx, gy=gy,
                    gz=gz)
    for d, (size, st) in enumerate(dims):
        launch.size[d] = size
        for k in range(N_OPS):
            launch.stride[k][d] = st[k]
    return Plan(shape, rows, n, dims, a_col, b_col, chained, vec, THREADS,
                (gx, gy, gz), False, launch)


def _launch(pl: Plan, out, a, b, q, qinv, c) -> int:
    """Enqueue the kernel on the current device's current stream (the raw
    handle: building a ``torch.cuda.Stream`` costs more than the rest of
    the call)."""
    return cuda_lib.lib().optconv_mont_mul(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), q.data_ptr(),
        qinv.data_ptr(), c.data_ptr(), ctypes.addressof(pl.launch),
        torch._C._cuda_getCurrentRawStream(out.device.index))


def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                  qinv: torch.Tensor, c: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """a·b·2^-64 mod q on the card or, with `c`, (a·b·2^-64)·c·2^-64 mod q
    in the same pass.  Raises unless every operand is an int64 CUDA
    tensor on one device."""
    t0 = tracing.stamp()
    dev = a.device
    ops = (a, b, q, qinv) if c is None else (a, b, q, qinv, c)
    for t in ops:
        if t.device != dev or t.dtype != torch.int64:
            raise TypeError(f"mont_mul_cuda: int64 tensors on {dev} expected, "
                            f"got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError("mont_mul_cuda needs CUDA tensors")
    if a.dim() and a.shape[-1] != 1 and a.stride(-1) != 1:
        a = a.contiguous()
    if b.dim() and b.shape[-1] != 1 and b.stride(-1) != 1:
        b = b.contiguous()
    pl = plan(*describe(a, b, q, qinv, c))
    if pl.collapse:
        # more unmergeable row dims than the kernel indexes: materialise
        # the broadcasts once; contiguous operands merge into one row dim
        rshape = pl.shape[:-1] + (1,)
        return mont_mul_cuda(*[
            t.expand(pl.shape if t.dim() and t.shape[-1] != 1 else rshape)
            .contiguous() for t in (a, b) + ops[2:]])
    out = torch.empty(pl.shape, dtype=torch.int64, device=dev)
    if pl.rows * pl.n == 0:
        return out
    if torch.cuda.current_device() == dev.index:
        code = _launch(pl, out, a, b, q, qinv, q if c is None else c)
    else:
        with torch.cuda.device(dev):
            code = _launch(pl, out, a, b, q, qinv, q if c is None else c)
    cuda_lib.check(code, "mont_mul kernel")
    STATS.launched(pl.rows, t0)
    return out
