"""Multi-device sharding of the CKKS layer step over ``torch.distributed``.

Counterpart of ``optimal_conv_tpu/parallel/sharding.py``.  The JAX module
lays a (dp, tp) or (dcn, dp, tp) mesh over the chips and lets GSPMD
insert every collective from the shardings of the inputs.  Nothing in
PyTorch partitions int64 modular arithmetic that runs through
hand-written kernels, so this module is per-rank code that writes out
the communication GSPMD inserted, as explicit collectives on the process
groups of a ``torch.distributed`` device mesh:

  dcn  data parallel across nodes (outermost): each image's layers are
       independent, so no collective on the hot path; nodes share keys
       once (``share_galois_key``).
  dp   data parallel within a node: a batch of ciphertexts, the
       reference's outer loop over images; no collective either.
  tp   the RNS limb axis.  NTTs, pointwise products and the Galois
       gather are limb-local; the key switch's two basis extensions and
       the rescale cross limbs:
         * ModUp: all-gather of the coefficient-form c1 [l+1, N], then
           every rank extends all digits to its own Q and P targets;
         * mod-down: all-gather of the coefficient-form P rows [|P|, N];
         * rescale: broadcast of the coefficient-form top limb [1, N].

The step (``ShardedLayerStep``) places the limbs in contiguous ranges
split afresh at each level (``limb_split``).  The whole fused layer runs
on ``parallel/limbs.LimbShardedContext``, the evaluator itself on one
rank's limbs with a fixed owner per limb; ``dryrun_fused_layer`` drives
it, as the JAX module's does, and holds it to the single device.

  sp   the coefficient axis (innermost, on request: ``build_mesh(shape,
       sp=k)``): rank s holds the columns [s·N/sp, (s+1)·N/sp) of every
       row.  Products, basis extensions and the rescale's arithmetic are
       column-local; ``parallel/coeffs.py`` writes out what crosses
       columns: log2(sp) stage-wise partner exchanges a forward or
       inverse NTT, and one shard transfer (or none) a Galois gather.
       The step runs on an sp mesh with a ``CoeffShardedContext``; the tp
       collectives then run within each tp group at a fixed sp
       coordinate, on N/sp columns.

Collectives run on NCCL where every rank has a card of its own, and on
gloo on the CPU and where several ranks share one card (NCCL refuses two
ranks on one device; gloo stages CUDA tensors through host memory).

Every step is exact modular arithmetic on each limb, and every rank
computes the correction count of the digit extension from the same
gathered digits in the same order (``core/rns._f32_count``), so the
sharded step equals the single-device ``rescale(rotate(mul_plain))``
residue for residue.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..ckks.context import CkksContext, SwitchingKey
from ..ckks.params import CkksParams
from ..ckks.types import Ciphertext
from ..core import modmath as mm
from ..core import ntt as nttmod
from ..device import resolve_device

AXES = ("dp", "tp")
HYBRID_AXES = ("dcn", "dp", "tp")
SP = "sp"
# every process group's collectives give up after this: a hung collective
# fails its run instead of holding it
TIMEOUT = timedelta(seconds=60)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _tp_width(n: int) -> int:
    """The tp factor of n devices: the largest power of two ≤ 4 dividing
    n (the JAX module's greedy fill of the fastest links)."""
    tp = 1
    while tp * 2 <= n and n % (tp * 2) == 0 and tp < 4:
        tp *= 2
    return tp


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(dp, tp) of n devices, as the JAX ``make_mesh`` factors them."""
    tp = _tp_width(n_devices)
    return n_devices // tp, tp


def hybrid_mesh_shape(n_devices: int, n_hosts: int | None = None
                      ) -> tuple[int, int, int]:
    """(dcn, dp, tp) of n devices on n_hosts nodes, as the JAX
    ``make_hybrid_mesh`` factors them (n_hosts defaults to 2 when n is
    even and > 1, else 1)."""
    n = n_devices
    hosts = n_hosts if n_hosts is not None else (2 if n % 2 == 0 and n > 1
                                                 else 1)
    if n % hosts:
        raise ValueError(f"{n} devices do not split over {hosts} hosts")
    per = n // hosts
    tp = _tp_width(per)
    return hosts, per // tp, tp


def _axis_names(shape, sp: int) -> tuple[str, ...]:
    return (AXES if len(shape) == 2 else HYBRID_AXES) + ((SP,) if sp > 1
                                                         else ())


class Mesh:
    """A (dp, tp) or (dcn, dp, tp) device mesh, with an innermost sp axis
    where `sp` > 1: the ranks laid out in `shape` (+ (sp,)) and, in a
    ``torch.distributed`` world, the ``DeviceMesh`` that holds one process
    group an axis.  Without a world it is a layout only, which a step can
    run on at one rank, with no collective."""

    def __init__(self, shape, device_mesh=None, sp: int = 1):
        if len(shape) not in (2, 3):
            raise ValueError(f"mesh shape {shape}: (dp, tp) or (dcn, dp, tp)")
        self.axis_names = _axis_names(shape, sp)
        shape = tuple(shape) + ((sp,) if sp > 1 else ())
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.devices = np.arange(math.prod(shape)).reshape(shape)
        else:
            self.devices = device_mesh.mesh.cpu().numpy().reshape(shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (0 along an axis the mesh lacks)."""
        if axis not in self.axis_names or self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank along `axis`, or None without a
        world (then every collective along it is the identity)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def build_mesh(shape, sp: int = 1) -> Mesh:
    """A Mesh of the given (dp, tp) or (dcn, dp, tp) shape, with an
    innermost sp axis of `sp` ranks where sp > 1.  In a
    ``torch.distributed`` world it must cover the world (ranks row-major,
    the last axis innermost) and is made by ``init_device_mesh``, a
    collective every rank calls; without a world, a layout only."""
    shape = tuple(int(s) for s in shape)
    if sp < 1:
        raise ValueError(f"sp {sp}")
    if not dist.is_initialized():
        return Mesh(shape, sp=sp)
    full = shape + ((sp,) if sp > 1 else ())
    if math.prod(full) != dist.get_world_size():
        raise ValueError(f"a mesh of {full} in a world of "
                         f"{dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                          full, mesh_dim_names=_axis_names(shape, sp))
    return Mesh(shape, dm, sp)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None) -> Mesh:
    """Factor the device count (default: the world's) into a (dp, tp)
    mesh, tp innermost so the limb collectives ride the fastest links."""
    n = _world_size() if n_devices is None else n_devices
    return build_mesh(mesh_shape(n))


def make_hybrid_mesh(n_devices: int | None = None,
                     n_hosts: int | None = None) -> Mesh:
    """A (dcn, dp, tp) mesh: dcn spans nodes, dp × tp each node's cards.

    In a world that spans nodes (``LOCAL_WORLD_SIZE`` below the world
    size, as torchrun sets it) dcn is node granularity; otherwise
    `n_hosts` nodes are emulated by the leading axis, as in the JAX
    module: the collectives' placement is the same, only the transport
    differs."""
    n = _world_size() if n_devices is None else n_devices
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    if n_hosts is None and dist.is_initialized() and 0 < local < n:
        n_hosts = n // local
    return build_mesh(hybrid_mesh_shape(n, n_hosts))


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

def default_backend(world_size: int) -> str:
    """NCCL where every rank of a node has a card of its own, else gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def _local_card(rank: int) -> int:
    """The card of a rank: its rank on its node (torchrun's LOCAL_RANK,
    else the rank) modulo the node's cards, so ranks beyond them share."""
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def local_device(device="cuda") -> torch.device:
    """This rank's device: "cpu", a given card, or for "cuda" its own
    card (``_local_card``).  Raises for a card without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", _local_card(
            dist.get_rank() if dist.is_initialized() else 0))
    return resolve_device(dev)


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None) -> int:
    """Join a ``torch.distributed`` world and return its size.

    A single process (no `init_method`, no torchrun environment) does
    nothing and returns 1, as the JAX module does.  Otherwise the world
    is joined through `init_method` ("file://…" or "tcp://host:port";
    "env://" by default, with torchrun's ``WORLD_SIZE``/``RANK``), on
    `backend` (``default_backend``), with every collective bounded by
    ``TIMEOUT``; on a machine with cards the rank's card is set first
    (``_local_card``)."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if init_method is None and not env:
        return 1
    init_method = init_method or "env://"
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend = backend or default_backend(world_size)
    if torch.cuda.is_available():
        # before init_device_mesh, which takes torchrun's LOCAL_RANK as the
        # card where none is set: past the last card when ranks share one
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    return world_size


def _rank_main(fn, rank, world_size, init_method, backend, args, results):
    try:
        init_distributed(init_method, world_size, rank, backend)
        results.put((rank, True, fn(rank, *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), backend: str | None = None,
              timeout: float = 300.0) -> list:
    """fn(rank, *args) in `world_size` spawned processes that form one
    world over a file store: → the results by rank.  fn must be
    importable (a module-level function) and return something picklable.
    Raises when a rank raised or died, or when the ranks are not done
    within `timeout` seconds; every process is joined or killed."""
    spawn = torch.multiprocessing.get_context("spawn")
    results = spawn.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{os.path.join(d, 'store')}"
        procs = [spawn.Process(target=_rank_main, args=(
            fn, r, world_size, init, backend, tuple(args), results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died (exit codes {dead})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks not done in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def limb_split(n: int, parts: int) -> tuple[range, ...]:
    """n items in `parts` contiguous ranges, in order: the first n % parts
    hold ⌈n/parts⌉, the rest ⌊n/parts⌋ (none when n < parts)."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for r in range(parts):
        size = base + (r < extra)
        out.append(range(start, start + size))
        start += size
    return tuple(out)


@dataclass(frozen=True)
class Layout:
    """Where the shards of a [B, L, N] batch (or an unbatched [L, N]
    polynomial, `batch` None) lie on a mesh: the limb axis in the
    contiguous ranges `limbs`, one a tp index; the batch in
    ``limb_split(batch, parts)``, the parts the flattened coordinates of
    `batch_axes` (outer first); the coefficient axis in `sp` equal
    column ranges, one an sp index; replicated over every other axis."""
    limbs: tuple[range, ...]
    batch: int | None = None
    batch_axes: tuple[str, ...] = ()
    sp: int = 1

    def _batch_part(self, mesh: Mesh) -> int:
        part = 0
        for a in self.batch_axes:
            part = part * mesh.size(a) + mesh.coord(a)
        return part

    def local(self, mesh: Mesh) -> tuple[range | None, range]:
        """(batch range or None, limb range) that this rank holds."""
        limbs = self.limbs[mesh.coord("tp")]
        if self.batch is None:
            return None, limbs
        parts = math.prod(mesh.size(a) for a in self.batch_axes)
        return limb_split(self.batch, parts)[self._batch_part(mesh)], limbs

    def take(self, a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """This rank's shard of the whole tensor `a` (a view)."""
        b, limbs = self.local(mesh)
        if b is not None:
            a = a[b.start:b.stop]
        a = a[..., limbs.start:limbs.stop, :]
        if self.sp > 1:
            w = a.shape[-1] // self.sp
            s = mesh.coord(SP)
            a = a[..., s * w:(s + 1) * w]
        return a


def batch_parts(mesh: Mesh) -> int:
    """The number of batch shards of ``batch_sharding``: dcn × dp."""
    return mesh.size("dcn") * mesh.size("dp")


def batch_sharding(mesh: Mesh, n_limbs: int, batch: int) -> Layout:
    """[B, l+1, N] ciphertext batches: batch over (dcn, dp) on a hybrid
    mesh (node-local images: no cross-node traffic on the hot path), over
    dp otherwise; limbs over tp, coefficients over sp."""
    axes = ("dcn", "dp") if "dcn" in mesh.axis_names else ("dp",)
    return Layout(limb_split(n_limbs, mesh.size("tp")), batch, axes,
                  mesh.size(SP))


def ct_sharding(mesh: Mesh, n_limbs: int, batch: int | None = None) -> Layout:
    """[B, l+1, N] batches (or one [l+1, N] polynomial, batch None): batch
    over dp, limbs over tp, coefficients over sp, replicated over dcn."""
    return Layout(limb_split(n_limbs, mesh.size("tp")), batch,
                  ("dp",) if batch is not None else (), mesh.size(SP))


def key_sharding(mesh: Mesh, params: CkksParams, level: int) -> tuple[int, ...]:
    """Rows of a [beta, l+1+P, N] switching key at `level` that this rank
    holds: those of its own targets, its Q limbs then its P limbs (the P
    limbs split over tp as the Q limbs are); replicated over dp and dcn."""
    tp, r = mesh.size("tp"), mesh.coord("tp")
    nq = level + 1
    return (tuple(limb_split(nq, tp)[r])
            + tuple(nq + j for j in limb_split(params.num_p, tp)[r]))


def shard_ct(ct: Ciphertext, mesh: Mesh) -> Ciphertext:
    """This rank's shard of a ciphertext (or of a [B, l+1, N] batch of
    them) under ``ct_sharding``; level and scale stay the whole one's.

    Where the limb count does not divide tp, the limbs split unevenly:
    a rank holds ⌈L/tp⌉, ⌊L/tp⌋ or, below tp limbs, none.  (The JAX
    module shards the coefficient axis there instead; here the
    coefficients split over an sp axis of their own, where the mesh has
    one.)"""
    batch = ct.c0.shape[0] if ct.c0.dim() == 3 else None
    lay = ct_sharding(mesh, ct.c0.shape[-2], batch)
    return Ciphertext(lay.take(ct.c0, mesh), lay.take(ct.c1, mesh),
                      level=ct.level, scale=ct.scale)


def _all_gather(x: torch.Tensor, group, sizes, dim: int,
                log: dict | None = None, what: str = "") -> torch.Tensor:
    """The concatenation along `dim` of every rank's x in rank order, rank
    i holding sizes[i] rows.  Shards are padded to the largest, since a
    collective moves equal shards; `log[what]` gets (payload, moved)
    bytes.  Without a group, x itself."""
    if group is None:
        return x
    most = max(sizes)
    if most == 0:
        return x
    if x.shape[dim] < most:
        pad = list(x.shape)
        pad[dim] = most - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x, group=group)
    if log is not None:
        row = x.numel() // most * x.element_size()
        log[what] = (sum(sizes) * row, len(sizes) * most * row)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)


def gather_ct(ct: Ciphertext, mesh: Mesh, layout: Layout) -> Ciphertext:
    """The whole ciphertext (or batch) on every rank, from each rank's
    shard `ct` placed by `layout`: all-gathers over sp (columns), tp,
    then the batch axes, innermost first."""
    c = gather_stacked(torch.stack([ct.c0, ct.c1]), mesh, layout)
    return Ciphertext(c[0], c[1], level=ct.level, scale=ct.scale)


def gather_stacked(c: torch.Tensor, mesh: Mesh, layout: Layout) -> torch.Tensor:
    """``gather_ct`` of a [k, (B,) rows, cols] stack of shards placed by
    `layout` → [k, (B,) L, N] on every rank."""
    if layout.sp > 1:
        c = _all_gather(c, mesh.group(SP), [c.shape[-1]] * layout.sp, -1)
    c = _all_gather(c, mesh.group("tp"), [len(r) for r in layout.limbs], -2)
    if layout.batch is not None and layout.batch_axes:
        axes = layout.batch_axes
        dims = [mesh.size(a) for a in axes]
        sizes = np.array([len(r) for r in limb_split(layout.batch,
                                                     math.prod(dims))])
        sizes = sizes.reshape(dims)
        coords = tuple(mesh.coord(a) for a in axes)
        for k in reversed(range(len(axes))):
            block = sizes[coords[:k]].reshape(dims[k], -1).sum(1)
            c = _all_gather(c, mesh.group(axes[k]), block.tolist(), 1)
    return c


def share_galois_key(ctx: CkksContext, g: int, level: int) -> SwitchingKey:
    """φ_g's switching key at `level`, made by rank 0 of the world and
    broadcast once (d0, and d1 where the key stores it; a seed-compressed
    key's d1 is regenerated from the broadcast seed by each rank), then
    put in every rank's key cache under its tag.  Every rank then holds
    the same key bit for bit: ranks that made it themselves from one seed
    would agree only on one device type (the CPU's and the card's
    ``torch.Generator`` draw different noise).  Without a world, the
    context's own key."""
    if not dist.is_initialized():
        return ctx.galois_key(g, level)
    p = ctx.params
    g = g % (2 * p.n)
    shape = (len(p.digits(level)), len(p.qp_idx(level)), p.n)
    if dist.get_rank() == 0:
        swk = ctx.galois_key(g, level)
        meta = torch.tensor([mm.as_i64(swk.seed or 0), swk.seed is not None,
                             swk.d1 is not None], dtype=torch.int64,
                            device=ctx.device)
    else:
        swk = None
        meta = torch.zeros(3, dtype=torch.int64, device=ctx.device)
    dist.broadcast(meta, src=0)
    seed = int(meta[0]) & ((1 << 64) - 1) if int(meta[1]) else None
    d0 = swk.d0 if swk is not None else torch.empty(
        shape, dtype=torch.int64, device=ctx.device)
    dist.broadcast(d0, src=0)
    d1 = None
    if int(meta[2]):
        d1 = swk.d1 if swk is not None else torch.empty_like(d0)
        dist.broadcast(d1, src=0)
    if swk is None:
        swk = SwitchingKey(d0, d1, level, seed=seed)
        ctx.switching_keys[("gal", g, level)] = swk
    return swk


# ---------------------------------------------------------------------------
# the sharded layer step
# ---------------------------------------------------------------------------

class ShardedLayerStep:
    """One rank's part of the fused step ct×pt → φ_g → hybrid key switch
    → add → rescale on a batch, the limb axis split over the mesh's tp
    and, on a mesh with an sp axis, the coefficients over sp.

    Inputs, this rank's shards: c0, c1 [..., q, N/sp] (its Q limbs of
    ``limb_split(level+1, tp)``, its columns), pt [q, N/sp] (NTT +
    Montgomery; ``shard_pt`` takes them), perm (``ctx.galois_perm(g)``),
    d0, d1 [beta, q+p, N/sp] (the key rows of ``key_sharding``, its
    columns; ``shard_key`` takes them).  Output: (o0, o1), its Q limbs
    but the top one, ``out_limbs``, its columns.

    On an sp mesh `ctx` is a ``parallel/coeffs.CoeffShardedContext`` on
    the same mesh: its NTTs and its Galois gather are the distributed
    ones, and the context's own arithmetic runs on the columns unchanged.

    The collectives, in order, on the tp group: the all-gather of the
    coefficient-form c1 before the digit extension, of the coefficient-
    form P rows of both halves before the mod-down, and the broadcast of
    both halves' coefficient-form top limb by its owner before the
    rescale.  The rest is the context's own arithmetic on this rank's
    limbs (``_ks_core``, ``_mod_down_limbs``, ``_rescale_limbs``).
    ``bytes`` holds (payload, moved) bytes of each tp collective in the
    last call, ``moved`` counting the padding of uneven shards (the sp
    transfers are counted by ``ctx.ntt.comm``)."""

    def __init__(self, ctx: CkksContext, level: int, mesh: Mesh):
        if level < 1:
            raise ValueError("the step rescales: level ≥ 1")
        if mesh.device_mesh is None and mesh.devices.size > 1:
            raise ValueError("a mesh of several ranks needs a torch.distributed "
                             "world (init_distributed)")
        p = ctx.params
        self.sp = mesh.size(SP)
        if self.sp > 1:
            from .coeffs import CoeffShardedContext, shard_cols
            if not (isinstance(ctx, CoeffShardedContext) and ctx.mesh is mesh):
                raise ValueError("a step on an sp mesh needs a "
                                 "CoeffShardedContext on that mesh")
            self.cols = shard_cols(p.n, self.sp, mesh.coord(SP))
        self.ctx, self.level, self.mesh = ctx, level, mesh
        tp, r = mesh.size("tp"), mesh.coord("tp")
        self.group = mesh.group("tp")
        self.q_limbs = limb_split(level + 1, tp)
        self.p_limbs = limb_split(p.num_p, tp)
        self.owner = max(i for i, rg in enumerate(self.q_limbs) if len(rg))
        self.out_limbs = tuple(
            range(rg.start, rg.stop - (i == self.owner))
            for i, rg in enumerate(self.q_limbs))
        self.own_q = tuple(self.q_limbs[r])
        self.own_p = tuple(p.p_idx()[j] for j in self.p_limbs[r])
        self.sub = tuple(self.out_limbs[r])
        self.targets = self.own_q + self.own_p
        self.key_rows = key_sharding(mesh, p, level)
        self.is_owner = r == self.owner
        self.digits = (ctx.tables.digit_extender(level, self.targets)
                       if self.targets else None)
        self.bytes: dict = {}

    def _cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of whole rows (a view)."""
        return t if self.sp == 1 else t[..., self.cols]

    def shard_pt(self, pt_poly: torch.Tensor) -> torch.Tensor:
        """This rank's rows and columns of a whole [l+1, N] plaintext."""
        rg = self.q_limbs[self.mesh.coord("tp")]
        return self._cols(pt_poly[..., rg.start:rg.stop, :])

    def shard_key(self, swk: SwitchingKey) -> tuple[torch.Tensor, torch.Tensor]:
        """(d0, d1) rows of this rank's targets, its columns; d1 stored,
        memoised or regenerated whole (``swk_d1``)."""
        if swk.level != self.level:
            raise ValueError(f"key of level {swk.level} for a step at "
                             f"level {self.level}")
        sel = torch.tensor(self.key_rows, dtype=torch.int64,
                           device=swk.d0.device)
        return (self._cols(swk.d0).index_select(1, sel),
                self._cols(self.ctx.swk_d1(swk)).index_select(1, sel))

    def out_layout(self, layout: Layout) -> Layout:
        """The layout of the output of inputs placed by `layout`."""
        return Layout(self.out_limbs, layout.batch, layout.batch_axes,
                      layout.sp)

    def __call__(self, c0, c1, pt, perm, d0, d1):
        nq = len(self.own_q)
        if c0.shape[-2] != nq or c1.shape[-2] != nq or pt.shape[-2] != nq:
            raise ValueError(f"this rank holds {nq} limbs: got c0 "
                             f"{tuple(c0.shape)}, c1 {tuple(c1.shape)}, pt "
                             f"{tuple(pt.shape)}")
        if d0.shape[-2] != len(self.targets) or d1.shape[-2] != len(self.targets):
            raise ValueError(f"key rows {tuple(d0.shape)} / {tuple(d1.shape)} "
                             f"for {len(self.targets)} targets")
        ctx, lvl = self.ctx, self.level
        q, qinv = ctx.ntt.tabs(self.own_q)[:2]
        # ct × pt and φ_g: limb-local (a column shard moves whole)
        c0p = ctx._permute(mm.mont_mul(c0, pt, q, qinv), perm)
        c1p = ctx._permute(mm.mont_mul(c1, pt, q, qinv), perm)
        ks0, ks1 = self.keyswitch(c1p, d0, d1)
        r0, r1 = (mm.add_mod(c0p, ks0, q), ks1) if nq else (c0p, c0p)
        # rescale: the owner's top limb, broadcast in coefficient form
        if self.is_owner:
            top = ctx.ntt.intt(torch.stack([r0[..., -1:, :], r1[..., -1:, :]]),
                               (lvl,))
        else:
            top = c0p.new_empty((2,) + tuple(c0p.shape[:-2]) + (1, c0.shape[-1]))
        if self.group is not None:
            dist.broadcast(top, src=dist.get_global_rank(self.group, self.owner),
                           group=self.group)
            self.bytes["top broadcast"] = (top.numel() * 8,) * 2
        if not self.sub:
            return r0[..., :0, :], r1[..., :0, :]
        ns = len(self.sub)
        return (ctx._rescale_limbs(r0[..., :ns, :], top[0], lvl, self.sub),
                ctx._rescale_limbs(r1[..., :ns, :], top[1], lvl, self.sub))

    def keyswitch(self, c1p: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor):
        """The hybrid key switch of this rank's shard c1p [..., q, N/sp]
        (NTT domain) with its key rows → (ks0, ks1) on its Q limbs, divided
        by P; a rank without a Q limb gets its (empty) c1p twice.  It
        still takes part in every collective of its tp group.

        ModUp: every rank extends the whole c1 to its own targets and
        takes the inner product with its own key rows; mod-down: the P
        rows of both halves, gathered, extended to its own Q limbs."""
        ctx, lvl = self.ctx, self.level
        nq = len(self.own_q)
        self.bytes = {}
        c1c = _all_gather(ctx.ntt.intt(c1p, self.own_q), self.group,
                          [len(r) for r in self.q_limbs], -2, self.bytes,
                          "c1 all_gather")
        if self.digits is None:
            acc0 = acc1 = c1c.new_empty(c1c.shape[:-2] + (0, c1c.shape[-1]))
        else:
            acc0, acc1 = ctx._ks_core(self.digits.extend_digits(c1c), d0, d1,
                                      lvl, lazy=True, idx=self.targets)
        acc_p = ctx.ntt.intt(torch.stack([acc0[..., nq:, :], acc1[..., nq:, :]]),
                             self.own_p)
        acc_p = _all_gather(acc_p, self.group, [len(r) for r in self.p_limbs],
                            -2, self.bytes, "P all_gather")
        if not nq:
            return c1p, c1p
        return (ctx._mod_down_limbs(acc0[..., :nq, :], acc_p[0], lvl, self.own_q),
                ctx._mod_down_limbs(acc1[..., :nq, :], acc_p[1], lvl, self.own_q))


def build_sharded_layer_step(ctx: CkksContext, level: int,
                             mesh: Mesh) -> ShardedLayerStep:
    """The mesh-sharded fused step at `level`: ct×pt conv product, Galois
    rotation (the full hybrid key switch) and rescale, on a batch; this
    rank's part (``ShardedLayerStep``)."""
    return ShardedLayerStep(ctx, level, mesh)


def dryrun(n_devices: int, log_n: int = 8, levels: int = 7,
           batch: int | None = None, device="cuda", sp: int = 1) -> dict:
    """Run one sharded layer step on an n-rank mesh and check it: output
    shape [b, level, N] and, residue for residue, the single-device
    ``rescale(rotate(mul_plain(ct, pt), 1))``.  n ≥ 8 takes the hybrid
    (dcn, dp, tp) mesh, fewer (dp, tp); b is the batch parts' count by
    default.  Runs in the current world, whose size must be n (one
    process without a world for n = 1).  → the bytes of each collective
    (``ShardedLayerStep.bytes``).  With sp > 1, the coefficients split
    over an innermost sp axis of the world's n ranks and every sp check
    runs (``coeffs.dryrun_coeffs``): → the bytes of each collective and
    each kind of sp transfer of the step."""
    if sp > 1:
        from .coeffs import dryrun_coeffs
        return dryrun_coeffs(n_devices, sp, log_n, levels, batch,
                             device)["bytes"]
    if n_devices != _world_size():
        raise ValueError(f"dryrun({n_devices}) in a world of {_world_size()} "
                         "ranks: start it under torchrun or run_ranks")
    dev = local_device(device)
    mesh = make_hybrid_mesh(n_devices) if n_devices >= 8 else make_mesh(
        n_devices)
    params = CkksParams(log_n=log_n, logq=(45,) + (35,) * levels,
                        logp=(45, 45, 45, 45), log_scale=25, h=32)
    ctx = CkksContext(params, dev, seed=0)
    level = params.max_level
    b = batch_parts(mesh) if batch is None else batch

    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.n)
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(v, params.scale, level))
    pt = ctx.encoder.encode_coeffs(rng.uniform(-1, 1, 8), params.scale, level)
    g = nttmod.rot_to_galois(1, log_n)
    swk = share_galois_key(ctx, g, level)

    step = build_sharded_layer_step(ctx, level, mesh)
    lay = batch_sharding(mesh, level + 1, b)
    shape = (b,) + tuple(ct.c0.shape)
    o0, o1 = step(lay.take(ct.c0.expand(shape), mesh),
                  lay.take(ct.c1.expand(shape), mesh), step.shard_pt(pt.poly),
                  ctx.galois_perm(g), *step.shard_key(swk))
    out = gather_ct(Ciphertext(o0, o1, level=level - 1), mesh,
                    step.out_layout(lay))
    if tuple(out.c0.shape) != (b, level, params.n):
        raise AssertionError(f"dryrun: output {tuple(out.c0.shape)}, expected "
                             f"{(b, level, params.n)}")
    ref = ctx.rescale(ctx.rotate(ctx.mul_plain(ct, pt), 1))
    if not (torch.equal(out.c0, ref.c0.expand_as(out.c0))
            and torch.equal(out.c1, ref.c1.expand_as(out.c1))):
        raise AssertionError("dryrun: the sharded step differs from the "
                             "single-device rescale(rotate(mul_plain))")
    return step.bytes


# ---------------------------------------------------------------------------
# the sharded fused layer
# ---------------------------------------------------------------------------

FUSED_SEED = 7          # the JAX dryrun's context seed
FUSED_RNG = 5           # and its input generator's
FUSED_BOOT = dict(k_range=2.0, sin_deg=7, double_angle=1)


def fused_layer_legs(ctx: CkksContext, legs=(1, 2, 3), on_stage=None) -> dict:
    """The JAX ``dryrun_fused_layer``'s legs on `ctx` (single-device or
    limb-sharded): {leg: output ciphertext}, each the whole
    ``ops/pipeline.eval_conv_bn_relu``, one ``SplitBootstrapper(k_range=2,
    sin_deg=7, double_angle=1)`` a log_sparse:
      1. ``Conv_sparse``, keep repack, in_wid 16, log_sparse 1;
      2. ``StrConv_sparse``, ``ext_double`` repack on ``gen_comprs_sparse``
         maps, in_wid 8 → 4, combined log_sparse 1;
      3. ``Conv_sparse`` at log_sparse 3, in_wid 4.
    Every leg's input is drawn, in the JAX dryrun's order, from
    ``default_rng(FUSED_RNG)`` and encrypted by the context's generator,
    whether the leg runs or not."""
    from ..ckks.bootstrap import SplitBootstrapper
    from ..ops import conv as convops
    from ..ops import repack as rp
    from ..ops.pipeline import LayerMaps, eval_conv_bn_relu

    p = ctx.params
    n, kw = p.n, 3
    rng = np.random.default_rng(FUSED_RNG)
    inputs = {}

    def enc(img, raw, in_wid, norm):
        inp = convops.prep_input(img.ravel(), raw, in_wid, n, norm)
        return ctx.encrypt(ctx.encoder.encode_coeffs(inp, p.scale, 1))

    for leg, in_wid, ls in ((1, 16, None), (2, 8, 2), (3, 4, 3)):
        if leg == 2:
            raw_in, out_wid = in_wid - kw // 2, in_wid // 2
            raw_out = out_wid - kw // 2
            norm_in = 1 << ls
            real_ib = n // (in_wid * in_wid) // norm_in
            norm_out = 2 * norm_in
            real_ob = n // (out_wid * out_wid) // norm_out
            img = rng.uniform(-0.5, 0.5, (raw_in, raw_in, real_ib))
            ker = rng.uniform(-1, 1, (kw, kw, real_ib, real_ob)) / 4.0
            ct = enc(img, raw_in, in_wid, norm_in)
            m_idx, r_idx = rp.gen_comprs_sparse(n // 2, in_wid, raw_out,
                                                ls - 1, 0, 0)
            args = (ker.ravel(), np.ones(real_ob), np.zeros(real_ob), 0.0,
                    4.0, in_wid, raw_out, kw, real_ib, real_ob, norm_out, 0,
                    1, 2, ls - 1, "StrConv_sparse",
                    LayerMaps(m_idx=m_idx, r_idx=r_idx))
        else:
            raw = in_wid - kw // 2
            max_batch = n // (in_wid * in_wid)
            ls = max(int(np.log2(max_batch)) - 1, 1) if ls is None else ls
            norm = 1 << ls
            real_b = max_batch // norm
            img = rng.uniform(-0.5, 0.5, (raw, raw, real_b))
            ker = rng.uniform(-1, 1, (kw, kw, real_b, real_b)) / 4.0
            ct = enc(img, raw, in_wid, norm)
            maps = LayerMaps(ext_idx=[rp.gen_keep_vec_sparse(n // 2, in_wid,
                                                             raw, ls), None])
            args = (ker.ravel(), np.ones(real_b), np.zeros(real_b), 0.0, 4.0,
                    in_wid, raw, kw, real_b, real_b, norm, 0, 1, 2, ls,
                    "Conv_sparse", maps)
        inputs[leg] = (ct, args)
    btps, out = {}, {}
    for leg in sorted(legs):
        ct, args = inputs[leg]
        ls = args[14]
        if ls not in btps:
            btps[ls] = SplitBootstrapper(ctx, log_sparse=ls, **FUSED_BOOT)
        out[leg] = eval_conv_bn_relu(ctx, btps, ct, *args, on_stage=on_stage)
    return out


def _ct_digest(ct: Ciphertext) -> list:
    """[level, scale, sha256 of c0, of c1]: equal across processes iff the
    ciphertexts are equal residue for residue."""
    return [ct.level, ct.scale] + [
        hashlib.sha256(c.contiguous().cpu().numpy().tobytes()).hexdigest()
        for c in (ct.c0, ct.c1)]


def dryrun_fused_layer(n_devices: int, log_n: int = 9, device="cuda",
                       legs=(1, 2, 3), check: bool = True) -> dict:
    """Whole fused encrypted layers (conv + BN → CtoS → EvalMod → ReLU →
    repack → StoC, ``ops/pipeline.eval_conv_bn_relu`` unchanged) with the
    limb axis of every ciphertext, plaintext and key split over the tp
    axis of an n-rank (dp, tp) mesh: the JAX module's three legs
    (``fused_layer_legs``) on ``mini_boot_params(log_n, n_relu=14,
    stoc_groups=3)``, contexts of seed 7 on every rank
    (``parallel/limbs.LimbShardedContext``).

    Each leg's output must land at level ≥ 1 and decrypt to finite
    values and, with `check`, every rank first runs the legs on a
    single-device context of the same seed and requires the gathered
    output equal residue for residue, with equal level and scale.  Runs
    in the current world, whose size must be n (one process without a
    world for n = 1), on this rank's card unless `device` says "cpu".
    → {"digests": {leg: [level, scale, sha256 of c0, of c1]}, "comm": the
    collectives by kind ([calls, payload bytes, bytes moved]), "limbs":
    this rank's [stage, Q limbs of each ciphertext, P limbs]}."""
    from ..ckks.params import mini_boot_params
    from .limbs import LimbShardedContext

    if n_devices != _world_size():
        raise ValueError(f"dryrun_fused_layer({n_devices}) in a world of "
                         f"{_world_size()} ranks: start it under torchrun or "
                         "run_ranks")
    dev = local_device(device)
    params = mini_boot_params(log_n, n_relu=14, stoc_groups=3)
    want = {}
    if check:
        single = CkksContext(params, dev, seed=FUSED_SEED)
        want = {leg: _ct_digest(o)
                for leg, o in fused_layer_legs(single, legs).items()}
        del single
    ctx = LimbShardedContext(params, dev, make_mesh(n_devices),
                             seed=FUSED_SEED)
    limbs = []

    def on_stage(name, value):
        cts = value if isinstance(value, tuple) else (value,)
        limbs.append([name, [c.c0.shape[-2] for c in cts if c is not None],
                      len(ctx.p_rows())])

    digests = {}
    for leg, o in fused_layer_legs(ctx, legs, on_stage).items():
        got = ctx.decrypt_decode_coeffs(o)
        if o.level < 1 or not np.all(np.isfinite(got)):
            raise AssertionError(f"dryrun_fused_layer leg {leg}: level "
                                 f"{o.level}, finite {np.isfinite(got).all()}")
        digests[leg] = _ct_digest(ctx.gather_ct(o))
        if check and digests[leg] != want[leg]:
            raise AssertionError(f"dryrun_fused_layer leg {leg}: the sharded "
                                 "layer differs from the single device")
    return dict(digests=digests, comm=ctx.comm, limbs=limbs)


def main(argv=None) -> int:
    """``torchrun --nproc_per_node=k -m optimal_conv_tpu_torch.parallel.sharding``
    on a machine with k cards (or plain ``python -m`` for one): the
    dryrun on all ranks, its bytes a collective printed by rank 0.  With
    ``--fused``, ``dryrun_fused_layer`` instead (its default log_n 9):
    each leg's digest, the collectives by kind and the limbs by stage.
    With ``--sp k``, the coefficients split over an innermost sp axis of k
    ranks and every sp check runs (``coeffs.dryrun_coeffs``): each
    check's digest and the bytes of each collective and sp transfer."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--log-n", type=int, default=None)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--sp", type=int, default=1)
    args = ap.parse_args(argv)
    world = init_distributed()
    try:
        if args.fused:
            res = dryrun_fused_layer(world, args.log_n or 9, args.device)
        elif args.sp > 1:
            from .coeffs import dryrun_coeffs
            res = dryrun_coeffs(world, args.sp, args.log_n or 8, args.levels,
                                device=args.device)
        else:
            res = {"bytes": dryrun(world, args.log_n or 8, args.levels,
                                   device=args.device)}
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps({"world": world, **res}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
