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
16-byte accesses, the block size and the grid (``core/rowgeom.py``,
which the additive kernel's wrapper shares), and the ctypes structure
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
from . import cuda_lib, rowgeom

STATS = cuda_lib.KernelStats("mont_mul")
MAX_DIMS = rowgeom.MAX_DIMS
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
    `collapse` says the kernel cannot index the operands as they are
    (``rowgeom.Geometry``), so the wrapper must first materialise them."""
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
    geo = rowgeom.geometry("mont_mul_cuda", layout, range(len(layout)), N_OPS,
                           aligned, THREADS, PER_THREAD)
    launch = Launch(chained=chained, a_col=geo.cols[0], b_col=geo.cols[1])
    if geo.threads:
        rowgeom.fill(launch, geo, N_OPS)
    return Plan(geo.shape, geo.rows, geo.n, geo.dims, *geo.cols, chained,
                geo.vec, geo.threads, geo.grid, geo.collapse, launch)


def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                  qinv: torch.Tensor, c: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """a·b·2^-64 mod q on the card or, with `c`, (a·b·2^-64)·c·2^-64 mod q
    in the same pass.  Raises unless every operand is an int64 CUDA
    tensor on one device."""
    t0 = tracing.stamp()
    ops = (a, b, q, qinv) if c is None else (a, b, q, qinv, c)
    dev = rowgeom.device_of("mont_mul_cuda", ops)
    ops = rowgeom.rows_contiguous(ops, 2)
    pl = plan(*describe(*ops))
    if pl.collapse:
        # more unmergeable row dims than the kernel indexes: materialise
        # the broadcasts once; contiguous operands merge into one row dim
        return mont_mul_cuda(*rowgeom.materialise(pl.shape, ops))
    out = torch.empty(pl.shape, dtype=torch.int64, device=a.device)
    if pl.rows * pl.n == 0:
        return out
    a, b, q, qinv = ops[:4]
    code = rowgeom.launch(
        cuda_lib.lib().optconv_mont_mul, dev, out.data_ptr(), a.data_ptr(),
        b.data_ptr(), q.data_ptr(), qinv.data_ptr(), ops[-1].data_ptr(),
        ctypes.addressof(pl.launch))
    cuda_lib.check(code, "mont_mul kernel")
    STATS.launched(pl.rows, t0)
    return out
