"""The row geometry of the port's elementwise kernels: K1
(``csrc/mont_mul.cu``, ``core/mont_kernel.py``) and the additive kernel
(``csrc/mod_add.cu``, ``core/mod_add_kernel.py``).

Both take int64 operands that broadcast the way ``torch`` broadcasts.
Each operand has a slot in the kernel's stride table: slots 0 and 1 are
the row operands a and b, which are rows or per-row scalars (a column
stride of 1 or 0), and the later slots are per-row constants such as q,
which may not vary along the last axis.  An operand is described by its
element strides along the merged row dims (0 where it is broadcast), and
one block computes one tile of one row.  ``geometry`` is the pure
integer part of both plans; ``rows_contiguous``, ``materialise`` and
``launch`` are the tensor parts of both wrappers.  ``csrc/row_index.cuh``
is the kernels' side: its ``RowIndex`` holds the merged dims and its
``row_offsets`` turns a block's row into the operands' offsets.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

MAX_DIMS = 4                   # kRowDims of csrc/row_index.cuh


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel covers one call's output.  `dims` are the merged row
    dims, outermost first, each (size, element strides by slot); `cols`
    says whether a and b are rows (1) or per-row scalars (0); `grid` is
    (tiles a row, gy, gz) with gy·gz >= rows, all 0 where nothing is
    launched; `collapse` says the kernel cannot index the operands as they
    are (the row dims did not merge into MAX_DIMS, or a row operand is
    strided along the last axis), so the wrapper must first materialise
    them."""
    shape: tuple
    rows: int
    n: int
    dims: tuple
    cols: tuple
    vec: bool
    threads: int
    grid: tuple
    collapse: bool


def merge_row_dims(shape, strides):
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


def broadcast_strides(shape, op_shape, op_stride):
    """Element strides of an operand along every dim of `shape`: 0 where
    it is broadcast (a missing or size-1 dim)."""
    lead = len(shape) - len(op_shape)
    return tuple(0 if d < lead or op_shape[d - lead] == 1 else
                 op_stride[d - lead] for d in range(len(shape)))


def geometry(what: str, layout, slots, n_slots: int, aligned, threads: int,
             per_thread: int, vec_ok: bool = True) -> Geometry:
    """The geometry of one call.  `layout` holds each operand's (shape,
    strides), `slots` each operand's slot among `n_slots` (a slot no
    operand fills reads as broadcast everywhere), `aligned` whether a and
    b start on a 16-byte boundary; a tile is `threads` x `per_thread`
    units, a unit a 16-byte vector of two elements when the accesses may
    be 16 bytes wide (and `vec_ok`, the caller's own condition), else one
    element.  Pure integer arithmetic: no tensor, no device.  Raises for
    what no launch can take."""
    shape = tuple(torch.broadcast_shapes(*[s for s, _ in layout]))
    if not shape:
        raise ValueError(f"{what} needs at least one axis")
    for slot, (s, _) in zip(slots, layout):
        if slot > 1 and s[-1:] not in ((), (1,)):
            raise ValueError(f"{what}: q and the other per-row operands must "
                             "be constant along the last axis")
    n = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    strides = [(0,) * len(shape)] * n_slots
    for slot, (s, st) in zip(slots, layout):
        strides[slot] = broadcast_strides(shape, s, st)
    row_ops = [k for k in (0, 1) if k in slots]
    cols = tuple(int(k in row_ops and n > 1 and strides[k][-1] == 1)
                 for k in (0, 1))
    dims = merge_row_dims(shape, strides)
    collapse = len(dims) > MAX_DIMS or any(
        n > 1 and strides[k][-1] not in (0, 1) for k in row_ops)
    if rows * n == 0 or collapse:
        return Geometry(shape, rows, n, dims, cols, False, 0, (0, 0, 0),
                        collapse)
    if rows >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"{what}: {rows} rows of {n} exceed the kernel's "
                         "32-bit row and column indices")

    def in_16_bytes(k):
        return not cols[k] or (aligned[k] and all(st[k] % 2 == 0
                                                  for _, st in dims))

    vec = vec_ok and n % 2 == 0 and in_16_bytes(0) and in_16_bytes(1)
    units = n // 2 if vec else n
    gy = min(rows, 32768)
    grid = (-(-units // (threads * per_thread)), gy, -(-rows // gy))
    return Geometry(shape, rows, n, dims, cols, vec, threads, grid, False)


def fill(launch: ctypes.Structure, geo: Geometry, n_slots: int) -> None:
    """Write the geometry's fields into a kernel's ctypes launch
    description (``n``, ``rows``, ``size``, ``stride``, ``nd``, ``vec``,
    ``threads``, ``gx``, ``gy``, ``gz``; the rest is the caller's)."""
    launch.n, launch.rows, launch.nd = geo.n, geo.rows, len(geo.dims)
    launch.vec, launch.threads = geo.vec, geo.threads
    launch.gx, launch.gy, launch.gz = geo.grid
    for d, (size, st) in enumerate(geo.dims):
        launch.size[d] = size
        for k in range(n_slots):
            launch.stride[k][d] = st[k]


def device_of(what: str, ops) -> int:
    """The CUDA device index of `ops`; raises unless they are all int64
    tensors on one CUDA device."""
    idx = ops[0].get_device()
    for t in ops:
        if t.dtype is not torch.int64 or t.get_device() != idx:
            raise TypeError(f"{what}: int64 tensors on {ops[0].device} "
                            f"expected, got {t.dtype} on {t.device}")
    if idx < 0:
        raise ValueError(f"{what} needs CUDA tensors")
    return idx


def rows_contiguous(ops, n_rows: int) -> tuple:
    """`ops` with each of the first `n_rows` (the row operands) made
    contiguous where it is strided along the last axis: a copy of that
    operand alone, where `materialise` would copy every operand."""
    return tuple(t.contiguous() if t.dim() and t.shape[-1] != 1
                 and t.stride(-1) != 1 else t for t in ops[:n_rows]) \
        + tuple(ops[n_rows:])


def materialise(shape: tuple, ops) -> tuple:
    """The operands of a collapsed call, broadcast to the output's `shape`
    (rows) or its rows (per-row scalars) and contiguous: they merge into
    one row dim."""
    rshape = shape[:-1] + (1,)
    return tuple(t.expand(shape if t.dim() and t.shape[-1] != 1 else rshape)
                 .contiguous() for t in ops)


def launch(entry, dev: int, *args) -> int:
    """entry(*args, stream) on the raw handle of device `dev`'s current
    stream (building a ``torch.cuda.Stream`` costs more than the rest of
    a call), entering the device's context only when it is not the
    current one; the entry point's CUDA error code."""
    if torch.cuda.current_device() == dev:
        return entry(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return entry(*args, torch._C._cuda_getCurrentRawStream(dev))
