"""The four-step matrix NTT on the card's int8 tensor cores
(``csrc/mxu_ntt.cu``).

Replaces ``optimal_conv_tpu/core/mxu_ntt.py`` (``_fwd_body``,
``_inv_body`` and their ``_mod_matmul``): on the TPU an XLA composite, an
int8 einsum on the MXU and the recombination of its byte-diagonal
groups, not a Pallas kernel.  The tables it reads are a
``core.mxu_ntt.MxuNttTables`` on the same device; the plain versions are
``core.mxu_ntt.mxu_fwd_plain`` / ``mxu_inv_plain``, and
``core.ntt.NttContext`` picks between them and this wrapper by device.

One call is one entry point, ``optconv_mxu_ntt``: two launches of the
step kernel (the two modular matmuls, the middle twiddle fused into the
first) through one [rows, N] scratch tensor, over every row of the call,
each row at its limb's byte width.  The counters count calls, as K2/K3's
do.  What bounds it, and why this first kernel is slower than K2/K3, is
in ``csrc/mxu_ntt.cu``.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import cuda_lib
from .ntt_kernel import _row_strides

STATS_FWD = cuda_lib.KernelStats("mxu_fwd")
STATS_INV = cuda_lib.KernelStats("mxu_inv")


def mxu_cuda(a: torch.Tensor, idx, tabs, inverse: bool) -> torch.Tensor:
    """Transform the rows of a [..., l, N] int64 CUDA tensor out of place
    by the matrix route.

    idx: the global limbs of the l rows; tabs: the ``MxuNttTables`` on
    `a`'s device.  Each row runs its limb's byte width; the kernel's
    shared memory is sized for the widest limb of `idx`.

    `a` is read in place when its rows have unit stride and its leading
    dims collapse to one batch stride; any other view is copied once."""
    t0 = tracing.stamp()
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("mxu_cuda needs a CUDA tensor")
    n = tabs.n
    idx = tuple(idx)
    if a.dtype != torch.int64 or a.dim() < 2 or a.shape[-1] != n:
        raise ValueError(f"mxu_cuda: int64 [..., l, {n}] expected, got "
                         f"{a.dtype} {tuple(a.shape)}")
    if len(idx) != a.shape[-2]:
        raise ValueError(f"mxu_cuda: {len(idx)} limbs for {a.shape[-2]} rows")
    if tabs.q.device != dev:
        raise ValueError(f"mxu_cuda: tables on {tabs.q.device}, data on {dev}")
    rows = a.numel() // n
    out = torch.empty(a.shape, dtype=torch.int64, device=dev)
    if rows == 0:
        return out
    # the kernel sizes its shared memory for `planes` and runs each row at
    # its limb's width, so `planes` must be the widest of the rows' limbs
    planes = tabs.planes_for(idx)
    row_limb = tabs.row_limb(idx, rows // len(idx))
    strides = _row_strides(a)
    if strides is None:
        a = a.contiguous()
        strides = _row_strides(a)
    mid = torch.empty((rows, n), dtype=torch.int64, device=dev)
    wa, wb, tw = ((tabs.iv1, tabs.iv2, tabs.it_mont) if inverse else
                  (tabs.w1, tabs.w2, tabs.t_mont))
    lib = cuda_lib.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.optconv_mxu_ntt(
            a.data_ptr(), mid.data_ptr(), out.data_ptr(), row_limb.data_ptr(),
            tabs.q.data_ptr(), tabs.qinv.data_ptr(), tabs.r1.data_ptr(),
            tabs.c40.data_ptr(), tabs.c80.data_ptr(), tabs.nbytes_t.data_ptr(),
            wa.data_ptr(), wb.data_ptr(), tw.data_ptr(), rows, a.shape[-2],
            strides[0], strides[1], tabs.log_n, int(inverse), planes, stream)
    cuda_lib.check(code, "inverse matrix NTT kernel" if inverse
                   else "matrix NTT kernel")
    (STATS_INV if inverse else STATS_FWD).launched(rows, t0)
    return out
