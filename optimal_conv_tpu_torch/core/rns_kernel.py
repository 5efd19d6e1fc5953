"""The RNS basis extension on the card (``csrc/rns_extend.cu``).

New in the port, with no TPU kernel behind it: the JAX package's
``core/rns.py`` is a chain of ``jnp`` operations that XLA fuses on the
TPU, which PyTorch would run as about 52 launches.  ``core.rns``'s
``BasisExtender.extend`` and ``DigitExtender.extend_digits`` launch this
kernel once for a CUDA tensor and run their plain versions for a CPU
tensor.

An extension is described by its ``spec``: for each digit the input rows
of its source limbs and their moduli, and the destination moduli that
all digits share.  ``pack`` turns a spec into the kernel's constant
table, one row of ``layout``'s words a digit; ``plan`` describes one call
from the input's shape and strides.  Both are plain Python and pure, so
the CPU tests hold them (``tests/test_torch_rns_kernel.py``).  The table
and the plans are built once per extender and device and kept on the
extender; a call then checks its input, allocates its output and
launches on the current stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..utils import tracing
from . import cuda_lib

STATS = cuda_lib.KernelStats("rns_extend")

# The kernel's limits (csrc/rns_extend.cu: kMaxAlpha, kMaxRows, kThreads):
# source limbs a digit and destination rows, so that one destination
# row's sum of products stays below 2^65 times its modulus and a digit's
# table fits in shared memory; every modulus odd and below 2^62.
MAX_ALPHA = 8
MAX_ROWS = 64
MAX_MODULUS = 1 << 62
THREADS = 128
_GRID_YZ = 65535
_R64 = 1 << 64


class Launch(ctypes.Structure):
    """``OptconvRnsLaunch`` of csrc/rns_extend.cu, field for field."""
    _fields_ = [(name, ctypes.c_longlong) for name in
                ("n", "lead", "lead_stride", "row_stride")] + [
        (name, ctypes.c_int) for name in
        ("alpha", "beta", "r", "width", "threads", "gx", "gy", "gz")]


def layout(alpha: int, r: int) -> dict:
    """Where each constant lies in a digit's row of the table: name →
    (first word, words), and "width", the words of a row.  The kernel
    reads the same order (csrc/rns_extend.cu)."""
    parts = [("gather", alpha), ("q", alpha), ("qinv", alpha),
             ("qhat_inv", alpha), ("inv_bits", alpha), ("qhat", alpha * r),
             ("vq", r * (alpha + 1)), ("rq", r), ("rqinv", r)]
    out, at = {}, 0
    for name, words in parts:
        out[name] = (at, words)
        at += words
    out["width"] = at
    return out


def _i64(v: int) -> int:
    v %= _R64
    return v - _R64 if v >= 1 << 63 else v


def _qinv(q: int) -> int:
    """-q^-1 mod 2^64 as an int64 bit pattern."""
    return _i64(-pow(q, -1, _R64))


def pack(gather, src, dst) -> np.ndarray:
    """The kernel's constants of the extension `spec` = (gather, src,
    dst): [beta, width] int64 words.  Digit b extends its source limbs,
    input rows gather[b] of moduli src[b], to the moduli dst.  A digit
    with fewer than alpha limbs is padded with limbs of modulus 1 and
    zero constants, which add exactly nothing.  Raises on a spec the
    kernel does not take."""
    beta = len(src)
    if beta < 1 or len(gather) != beta:
        raise ValueError("rns_extend: one gather list a digit expected")
    alpha = max(len(s) for s in src)
    r = len(dst)
    if not 1 <= alpha <= MAX_ALPHA:
        raise ValueError(f"rns_extend: {alpha} source limbs a digit; the "
                         f"kernel takes 1 to {MAX_ALPHA}")
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"rns_extend: {r} destination rows; the kernel "
                         f"takes 1 to {MAX_ROWS}")
    for q in [int(q) for s in src for q in s] + [int(q) for q in dst]:
        if not (2 < q < MAX_MODULUS and q % 2):
            raise ValueError(f"rns_extend: modulus {q} is not an odd "
                             f"integer in (2, 2^62)")
    lay = layout(alpha, r)
    tab = np.zeros((beta, lay["width"]), dtype=np.int64)

    def put(b, name, i, value):
        tab[b, lay[name][0] + i] = _i64(value)

    for b, (rows, mods) in enumerate(zip(gather, src)):
        mods = [int(q) for q in mods]
        if len(rows) != len(mods) or not mods or min(rows) < 0:
            raise ValueError("rns_extend: one input row a source limb expected")
        big_q = 1
        for q in mods:
            big_q *= q
        for j in range(alpha):
            if j < len(mods):
                q = mods[j]
                put(b, "gather", j, int(rows[j]))
                put(b, "q", j, q)
                put(b, "qinv", j, _qinv(q))
                put(b, "qhat_inv", j, pow(big_q // q % q, -1, q) * _R64 % q)
                put(b, "inv_bits", j, int(np.float32(1.0 / q).view(np.uint32)))
                for i, d in enumerate(dst):
                    put(b, "qhat", j * r + i, big_q // q % d * _R64 % d)
            else:
                put(b, "q", j, 1)
                put(b, "qinv", j, _qinv(1))
        for i, d in enumerate(dst):
            for v in range(alpha + 1):
                put(b, "vq", i * (alpha + 1) + v, v * big_q % d)
            put(b, "rq", i, d)
            put(b, "rqinv", i, _qinv(d))
    return tab


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call: the output's shape, its rows (for ``KernelStats``),
    whether the input's leading dims must first be made contiguous (they
    do not merge into one stride), and the launch (None for an empty
    output)."""
    out_shape: tuple
    rows: int
    copy: bool
    launch: Launch | None = dataclasses.field(compare=False, repr=False)


def _merge_lead(shape, strides):
    """The leading dims as (count, stride) pairs, size-1 dims dropped and
    neighbours that step evenly merged."""
    merged: list = []
    for size, st in zip(shape, strides):
        if size == 1:
            continue
        if merged and merged[-1][1] == st * size:
            merged[-1] = (merged[-1][0] * size, st)
        else:
            merged.append((size, st))
    return merged


@functools.lru_cache(maxsize=4096)
def plan(alpha: int, beta: int, r: int, in_rows: int, digit_axis: bool,
         shape: tuple, strides: tuple) -> Plan:
    """The launch of one call on an input of `shape` and element
    `strides` ([..., L, n]), for a table of `beta` digits of `alpha`
    limbs into `r` rows whose gather reads rows below `in_rows`.  With
    `digit_axis` (``DigitExtender``) the input may hold more rows and the
    output is [..., beta, r, n]; without (``BasisExtender``, beta 1) the
    input holds exactly its `in_rows` source rows and the output is
    [..., r, n].  Pure integer arithmetic."""
    if len(shape) < 2:
        raise ValueError("rns_extend: input [..., L, n] expected")
    rows_in, n = shape[-2], shape[-1]
    if rows_in < in_rows or (not digit_axis and rows_in != in_rows):
        raise ValueError(f"rns_extend: input of {rows_in} rows, the "
                         f"extension reads {in_rows}")
    if n > 1 and strides[-1] != 1:
        raise ValueError("rns_extend: the input must be contiguous along N")
    lead_shape = tuple(shape[:-2])
    out_shape = lead_shape + ((beta,) if digit_axis else ()) + (r, n)
    lead = 1
    for s in lead_shape:
        lead *= s
    merged = _merge_lead(lead_shape, strides[:-2])
    copy = len(merged) > 1
    lead_stride = rows_in * n if copy else (merged[0][1] if merged else 0)
    row_stride = n if copy else strides[-2]
    rows = lead * beta * r
    if rows * n == 0:
        return Plan(out_shape, 0, copy, None)
    items = lead * beta
    if n >= 1 << 31 or items >= 1 << 31:
        raise ValueError(f"rns_extend: {items} digits of {n} columns exceed "
                         "the kernel's 32-bit indices")
    gy = min(items, _GRID_YZ)
    gz = -(-items // gy)
    if gz > _GRID_YZ:
        raise ValueError(f"rns_extend: {items} digits exceed the grid")
    launch = Launch(n=n, lead=lead, lead_stride=lead_stride,
                    row_stride=row_stride, alpha=alpha, beta=beta, r=r,
                    width=layout(alpha, r)["width"], threads=THREADS,
                    gx=-(-n // THREADS), gy=gy, gz=gz)
    return Plan(out_shape, rows, copy, launch)


class Table:
    """An extension's packed constants on one device, and its shape."""

    def __init__(self, spec, device):
        gather, src, dst = spec
        words = pack(gather, src, dst)
        self.alpha = max(len(s) for s in src)
        self.beta, self.r = len(src), len(dst)
        self.in_rows = max(max(g) for g in gather) + 1
        self.words = torch.from_numpy(words).to(device)


def extend_cuda(ext, x: torch.Tensor, digit_axis: bool) -> torch.Tensor:
    """The extension `ext` (a ``core.rns`` extender: its ``spec`` and its
    per-device ``_cuda`` tables) of x [..., L, n] in one launch:
    [..., beta, R, n] with `digit_axis`, else [..., R, n].  Raises unless
    x is an int64 CUDA tensor that the kernel takes."""
    t0 = tracing.stamp()
    dev = x.device
    if x.dtype != torch.int64:
        raise TypeError(f"rns_extend: int64 residues expected, got {x.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"rns_extend needs a CUDA tensor, got one on {dev}")
    tab = ext._cuda.get(dev)
    if tab is None:
        tab = ext._cuda[dev] = Table(ext.spec, dev)
    pl = plan(tab.alpha, tab.beta, tab.r, tab.in_rows, digit_axis,
              tuple(x.shape), x.stride())
    if pl.copy:
        x = x.contiguous()
    out = torch.empty(pl.out_shape, dtype=torch.int64, device=dev)
    if pl.launch is None:
        return out
    args = (out.data_ptr(), x.data_ptr(), tab.words.data_ptr(),
            ctypes.addressof(pl.launch))
    if torch.cuda.current_device() == dev.index:
        code = cuda_lib.lib().optconv_rns_extend(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            code = cuda_lib.lib().optconv_rns_extend(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    cuda_lib.check(code, "rns_extend kernel")
    STATS.launched(pl.rows, t0)
    return out
