"""The port's additive modular arithmetic on the card (``csrc/mod_add.cu``).

One launch computes one of five operations, each mod q on canonical int64
residues: ``add`` (a + b), ``sub`` (a − b), ``neg`` (−a), ``sum`` (Σ over
one axis of a stack, reduced after every addition) and ``centred`` (a − c
where b > half, else a: the centred correction of a rescale and of
ModRaise, b the top limb's coefficients broadcast over the rows).  It
replaces no TPU kernel: XLA fused ``optimal_conv_tpu/core/modmath.py``'s
``jnp.where`` chains, which PyTorch runs as 3-7 launches each.

The wrapper is K1's (``core/mont_kernel.py``), and shares its row
geometry (``core/rowgeom.py``): operands broadcast the way ``torch``
broadcasts, with q and c constant along the last axis, and each is
described to the kernel by its row strides (0 for a broadcast row dim)
and whether it is a row or a per-row scalar.  The description is a
``Plan``, a pure function of the operation, the operands' shapes,
strides and 16-byte alignment (``plan``), cached, with the ctypes
structure the C entry point reads built once.

The plain versions are ``core.modmath``'s ``*_plain`` functions;
``core.modmath.add_mod`` and its siblings pick between them and this
wrapper by the tensors' device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils import tracing
from . import cuda_lib, rowgeom

STATS = cuda_lib.KernelStats("mod_add")
MAX_DIMS = rowgeom.MAX_DIMS
N_OPS = 4                      # a, b, q, c
# The operation codes of csrc/mod_add.cu's Op, in order.
OPS = ("add", "sub", "neg", "sum", "centred")
ADD, SUB, NEG, SUM, CENTRED = range(len(OPS))
# The operands each operation takes, in the order `describe` lists them.
_ROLES = {ADD: "abq", SUB: "abq", NEG: "aq", SUM: "aq", CENTRED: "abqc"}

# One block is THREADS threads of PER_THREAD units each (a unit is a
# 16-byte vector of two elements on the vector path, one element on the
# scalar), K1's tile.  PER_THREAD is kPerThread of csrc/mod_add.cu.
THREADS = 128
PER_THREAD = 2


class Launch(ctypes.Structure):
    """``OptconvModAddLaunch`` of csrc/mod_add.cu, field for field."""
    _fields_ = [("n", ctypes.c_longlong), ("rows", ctypes.c_longlong),
                ("size", ctypes.c_longlong * MAX_DIMS),
                ("stride", (ctypes.c_longlong * MAX_DIMS) * N_OPS),
                ("step", ctypes.c_longlong), ("half", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in
        ("nd", "op", "k", "a_col", "b_col", "vec", "threads", "gx", "gy",
         "gz")]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call reaches the kernel.  `dims` are the merged row dims,
    outermost first, each (size, (a, b, q, c) element strides); `k` and
    `step` the sum's terms and their element stride; `collapse` says the
    kernel cannot index the operands as they are (the row dims did not
    merge into MAX_DIMS, or a row operand is strided along the last
    axis), so the wrapper must first materialise them."""
    op: int
    shape: tuple
    rows: int
    n: int
    dims: tuple
    k: int
    step: int
    a_col: int
    b_col: int
    vec: bool
    threads: int
    grid: tuple
    collapse: bool
    launch: Launch = dataclasses.field(compare=False, repr=False)


def describe(op: int, ops, k: int = 1, step: int = 0, half: int = 0):
    """The cache key of a call: the operation, each operand's (shape,
    strides), whether a and b start on a 16-byte boundary, the sum's
    terms and their stride, the centred form's threshold."""
    return (op, tuple([(t.shape, t.stride()) for t in ops]),
            (ops[0].data_ptr() % 16 == 0, ops[1].data_ptr() % 16 == 0), k,
            step, half)


@functools.lru_cache(maxsize=4096)
def plan(op, layout, aligned, k=1, step=0, half=0) -> Plan:
    """The launch plan of one call site, from `describe`'s key.  Pure
    integer arithmetic: no tensor, no device."""
    roles = _ROLES[op]
    if len(layout) != len(roles):
        raise ValueError(f"{OPS[op]} takes {len(roles)} operands")
    if op == SUM and k < 1:
        raise ValueError("a sum needs at least one term")
    geo = rowgeom.geometry("the mod_add kernel", layout,
                           ["abqc".index(r) for r in roles], N_OPS, aligned,
                           THREADS, PER_THREAD, op != SUM or step % 2 == 0)
    launch = Launch(step=step, half=half, op=op, k=k, a_col=geo.cols[0],
                    b_col=geo.cols[1])
    if geo.threads:
        rowgeom.fill(launch, geo, N_OPS)
    return Plan(op, geo.shape, geo.rows, geo.n, geo.dims, k, step, *geo.cols,
                geo.vec, geo.threads, geo.grid, geo.collapse, launch)


def _emit(pl: Plan, dev: int, ops, t0: int) -> torch.Tensor:
    """The output of a plan that needs no collapse, and its launch.  An
    operand the operation does not read is passed as q."""
    out = torch.empty(pl.shape, dtype=torch.int64, device=ops[0].device)
    if pl.rows * pl.n == 0:
        return out
    if len(ops) == 2:
        a, q = ops
        b = c = q
    else:
        a, b, q = ops[:3]
        c = ops[3] if len(ops) == 4 else q
    code = rowgeom.launch(cuda_lib.lib().optconv_mod_add, dev, out.data_ptr(),
                          a.data_ptr(), b.data_ptr(), q.data_ptr(),
                          c.data_ptr(), ctypes.addressof(pl.launch))
    cuda_lib.check(code, "mod_add kernel")
    STATS.launched(pl.rows, t0)
    return out


def _run(op: int, ops, t0: int, half: int = 0) -> torch.Tensor:
    """One launch of an elementwise `op` on `ops` (in `_ROLES` order)."""
    dev = rowgeom.device_of("the mod_add kernel", ops)
    ops = rowgeom.rows_contiguous(ops, 2 if len(_ROLES[op]) > 2 else 1)
    pl = plan(*describe(op, ops, half=half))
    if pl.collapse:
        return _run(op, rowgeom.materialise(pl.shape, ops), t0, half)
    return _emit(pl, dev, ops, t0)


def add_mod_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor
                 ) -> torch.Tensor:
    """a + b mod q in one launch.  Raises unless every operand is an int64
    CUDA tensor on one device."""
    return _run(ADD, (a, b, q), tracing.stamp())


def sub_mod_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor
                 ) -> torch.Tensor:
    """a − b mod q in one launch."""
    return _run(SUB, (a, b, q), tracing.stamp())


def neg_mod_cuda(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """−a mod q in one launch."""
    return _run(NEG, (a, q), tracing.stamp())


def centred_sub_cuda(a: torch.Tensor, b: torch.Tensor, half: int,
                     c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a − c mod q where b > half, else a, in one launch (b, the top
    limb's coefficients, broadcast over a's rows; 0 <= half < 2^63)."""
    return _run(CENTRED, (a, b, q, c), tracing.stamp(), int(half))


def sum_mod_cuda(t: torch.Tensor, q: torch.Tensor, dim: int = 0
                 ) -> torch.Tensor:
    """Σ_i t.select(dim, i) mod q in one launch: every term read once, the
    sum written once.  `dim` may not be the last axis."""
    t0 = tracing.stamp()
    dev = rowgeom.device_of("the mod_add kernel", (t, q))
    dim = dim % max(t.dim(), 1)
    if dim == t.dim() - 1:
        raise ValueError("sum_mod_cuda sums over a row axis, not the last")
    k = t.shape[dim]
    ops = (t.select(dim, 0), q)
    pl = plan(*describe(SUM, ops, k, t.stride(dim)))
    if pl.collapse:
        # the terms, broadcast and stacked along dim 0, contiguous
        lead = (1,) * (len(pl.shape) - (t.dim() - 1))
        full = t.movedim(dim, 0).reshape((k,) + lead + ops[0].shape)
        return sum_mod_cuda(full.expand((k,) + pl.shape).contiguous(), q, 0)
    return _emit(pl, dev, ops, t0)
