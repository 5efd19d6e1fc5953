"""K1: the elementwise Montgomery product on the card (``csrc/mont_mul.cu``).

Replaces ``optimal_conv_tpu/core/pallas_mod.py:mont_mul_pallas``.  The
wrapper takes int64 tensors that broadcast against each other the way
``torch`` broadcasts, with ``q``/``qinv`` constant along the last axis.
It describes each operand to the kernel by its row strides (a stride of
0 is a broadcast row dim) and its column stride (0 for a per-row scalar
such as a Montgomery constant), so broadcast operands are read in place
and never materialised.  Its plain version is
``core.modmath.mont_mul_plain``; ``core.modmath.mont_mul`` picks between
them by device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

STATS = cuda_lib.KernelStats("mont_mul")
_MAX_DIMS = 4


def _row_dims(shape, ops):
    """Row dims of `shape` (all but the last) with each operand's element
    strides, size-1 dims dropped and contiguous neighbours merged."""
    merged: list[tuple[int, list[int]]] = []
    for d in range(len(shape) - 1):
        size = shape[d]
        if size == 1:
            continue
        st = [t.stride(d) for t in ops]
        if merged:
            psize, pst = merged[-1]
            if all(ps == s * size for ps, s in zip(pst, st)):
                merged[-1] = (psize * size, st)
                continue
        merged.append((size, st))
    return merged


def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                  qinv: torch.Tensor) -> torch.Tensor:
    """a·b·2^-64 mod q on the card.  Raises unless every operand is an
    int64 CUDA tensor on one device."""
    dev = a.device
    for t in (a, b, q, qinv):
        if t.device != dev or t.dtype != torch.int64:
            raise TypeError(f"mont_mul_cuda: int64 tensors on {dev} expected, "
                            f"got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError("mont_mul_cuda needs CUDA tensors")
    shape = torch.broadcast_shapes(a.shape, b.shape, q.shape, qinv.shape)
    if q.shape[-1:] not in ((), (1,)) or qinv.shape[-1:] not in ((), (1,)):
        raise ValueError("q and qinv must be constant along the last axis")
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    n = shape[-1]
    rshape = shape[:-1] + (1,)
    ops = []
    cols = []
    for t in (a, b):
        if t.shape[-1:] == (n,) and n > 1 and t.stride(-1) != 1:
            t = t.contiguous()
        e = t.expand(shape)
        ops.append(e)
        cols.append(0 if n == 1 or t.shape[-1:] != (n,) else 1)
    ops += [q.expand(rshape), qinv.expand(rshape)]
    dims = _row_dims(shape, ops)
    if len(dims) > _MAX_DIMS:
        ops = [o.contiguous() for o in ops]
        dims = _row_dims(shape, ops)
    rows = out.numel() // n
    arr = ctypes.c_longlong * _MAX_DIMS
    size = arr(*[d[0] for d in dims])
    strides = [arr(*[d[1][k] for d in dims]) for k in range(4)]
    lib = cuda_lib.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.optconv_mont_mul(
            out.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(),
            ops[2].data_ptr(), ops[3].data_ptr(), rows, n, cols[0], cols[1],
            len(dims), size, *strides, stream)
    cuda_lib.check(code, "mont_mul kernel")
    STATS.launched(rows)
    return out
