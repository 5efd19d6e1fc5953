"""The sp axis: a ring's N coefficients split over the ranks of a mesh axis.

The JAX package names the axis in ``optimal_conv_tpu/parallel/sharding.py``
(``P(..., "sp")`` on the last axis of an [L, N] array) and lets GSPMD
insert the stage exchanges of the NTT.  Here they are written out.

Placement: rank s of sp holds the columns [s·N/sp, (s+1)·N/sp) of every
row, natural-order coefficients in coefficient form and bit-reversed
positions in NTT form, the split of ``P(..., "sp")``.

The negacyclic NTT (``core/ntt.py``: forward Cooley-Tukey, natural order
in, bit-reversed out) on that split:

  * the first log2(sp) forward stages (m = 1, 2, …, sp/2 twiddle blocks)
    pair rank s with s xor sp/(2m): the lower rank keeps u + w·v, the
    upper u − w·v, w = psi_br[m + s // (sp/m)].  One exchange of the
    whole shard a stage, one launch of the cross-stage kernel
    (``csrc/ntt.cu`` ``optconv_ntt_cross``);
  * then every shard is an independent N/sp-point sub-transform whose
    stage m' reads the twiddles psi_br[m'·(sp + s) + b]: the existing
    K2 kernel at log_n − log2(sp) on a per-shard table (``shard_twiddles``)
    computes it unchanged;
  * the inverse runs the local sub-transform first (K3 on the shard's
    ipsi_br table, with the *whole* ring's n⁻¹), then the cross stages
    h = sp/2 … 1: lower keeps u + v, upper (u − v)·w.

The NTT-domain Galois automorphism maps each shard onto one whole shard
(position j holds the exponent 2·brev(j)+1, the shard bits of j are that
exponent's low bits, and an odd g keeps the low bits of the product a
function of the low bits alone), so φ_g is one transfer of one shard, or
none, and a local gather (``shard_galois``).

``CoeffShardedNtt`` is the transform and the gather on one rank, with the
interface of ``NttContext`` that the evaluator uses; ``CoeffShardedContext``
is a CKKS context whose evaluator runs on column shards through it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ckks.context import CkksContext, SwitchingKey
from ..ckks.params import CkksParams
from ..ckks.types import Ciphertext, Plaintext
from ..core import ntt_kernel
from ..core.ntt import (NttContext, _ntt_fwd, _ntt_inv, galois_perm_ntt,
                        ntt_cross_plain, rot_to_galois)
from . import sharding as shd
from .sharding import Mesh


def _log2(sp: int) -> int:
    if sp < 1 or sp & (sp - 1):
        raise ValueError(f"sp {sp} is not a power of two")
    return sp.bit_length() - 1


def shard_cols(n: int, sp: int, s: int) -> slice:
    """The columns of rank s of sp in a ring of n coefficients."""
    w = n // sp
    return slice(s * w, (s + 1) * w)


def shard_twiddles(tw: torch.Tensor, sp: int, s: int) -> torch.Tensor:
    """Rank s's [L, N/sp] table of a whole [L, N] psi_br (or ipsi_br)
    table: its entry m' + b (m' a power of two, b < m') is the whole
    table's m'·(sp + s) + b; entry 0, never read, is the whole table's 0."""
    j = np.arange(tw.shape[-1] // sp, dtype=np.int64)
    m = np.zeros_like(j)
    m[1:] = 1 << np.log2(j[1:]).astype(np.int64)      # the largest 2^k ≤ j
    idx = torch.from_numpy(j + m * (sp + s - 1)).to(tw.device)
    return tw.index_select(-1, idx).contiguous()


def cross_stages(sp: int, s: int, inverse: bool) -> tuple:
    """The cross stages of rank s of sp in execution order: (partner,
    upper, twiddle column) each, the column of psi_br (forward) or
    ipsi_br (inverse) that the stage multiplies by."""
    out = []
    blocks = [1 << k for k in range(_log2(sp))]       # m (or h) = 1 … sp/2
    for m in (reversed(blocks) if inverse else blocks):
        half = sp // (2 * m)
        out.append((s ^ half, bool(s & half), m + s // (sp // m)))
    return tuple(out)


class ShardPerm(NamedTuple):
    """φ_g in the NTT domain on rank s of sp: output shard s is input
    shard `src` gathered by `local` [N/sp]; this rank's own shard goes to
    rank `dst` (σ⁻¹(s)).  `whole` is the whole ring's permutation [N]."""
    whole: torch.Tensor
    src: int
    dst: int
    local: torch.Tensor


@functools.lru_cache(maxsize=None)
def shard_galois(log_n: int, g: int, sp: int, s: int):
    """(σ(s), σ⁻¹(s), local [N/sp]) of φ_g on rank s of sp: output shard s
    is input shard σ(s) gathered by local (``galois_perm_ntt``'s entries
    of the shard, less σ(s)·N/sp).  Raises if a shard does not map onto
    one whole shard."""
    perm = galois_perm_ntt(log_n, g)
    w = perm.size // sp
    sigma = perm[::w] // w
    blocks = perm.reshape(sp, w) // w
    if not (np.all(blocks == sigma[:, None])
            and np.array_equal(np.sort(sigma), np.arange(sp))):
        raise AssertionError(f"φ_{g} does not map whole shards at sp {sp}")
    local = perm[s * w:(s + 1) * w] - sigma[s] * w
    local.setflags(write=False)
    return int(sigma[s]), int(np.flatnonzero(sigma == s)[0]), local


class CoeffShardedNtt:
    """The negacyclic NTT and the Galois gather on one rank of the mesh's
    sp group, over the whole-ring tables of `whole`.

    Rows as wide as the ring (the secret-key side: keys, encryption,
    decryption) go through `whole`'s transform on this rank alone; rows
    N/sp wide are a column shard and go through the distributed one, a
    collective of the sp group: every rank of the group calls it with
    the same shape.  On the CPU the plain versions run; on a CUDA tensor
    the kernels (K2/K3 on the shard's tables, the cross-stage kernel).

    ``comm`` counts the transfers by kind ("ntt cross", "intt cross",
    "galois"): [transfers, payload bytes, bytes moved], this rank's
    sends (each transfer also receives as many bytes)."""

    def __init__(self, whole: NttContext, mesh: Mesh):
        self.whole = whole
        self.sp, self.s = mesh.size("sp"), mesh.coord("sp")
        log_sp = _log2(self.sp)
        self.group = mesh.group("sp")
        if self.sp > 1 and self.group is None:
            raise ValueError("an sp axis of several ranks needs a "
                             "torch.distributed world (init_distributed)")
        self.n = whole.n
        self.log_cols = whole.log_n - log_sp
        if self.log_cols < 1:
            raise ValueError(f"sp {self.sp} leaves fewer than 2 columns a rank")
        self.cols = shard_cols(whole.n, self.sp, self.s)
        self.tw = shard_twiddles(whole.psi_br, self.sp, self.s)      # [L, N/sp]
        self.itw = shard_twiddles(whole.ipsi_br, self.sp, self.s)
        self._stages = {
            inv: tuple((self._global(peer), upper,
                        (whole.ipsi_br if inv else whole.psi_br)[:, col]
                        .contiguous())
                       for peer, upper, col in cross_stages(self.sp, self.s, inv))
            for inv in (False, True)}
        self._perms: dict = {}
        self.comm: dict = {}

    def _global(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    def tabs(self, idx: tuple[int, ...]):
        return self.whole.tabs(idx)

    def ntt(self, a: torch.Tensor, idx=None) -> torch.Tensor:
        """Forward NTT of [..., l, N] (whole) or [..., l, N/sp] (a shard)."""
        return self._transform(a, idx, inverse=False)

    def intt(self, a: torch.Tensor, idx=None) -> torch.Tensor:
        """Inverse NTT of [..., l, N] (whole) or [..., l, N/sp] (a shard)."""
        return self._transform(a, idx, inverse=True)

    # ---- the distributed transform ---------------------------------------

    def _is_shard(self, a: torch.Tensor) -> bool:
        """True for a column shard, False for whole rows; raises else."""
        if a.shape[-1] == self.n:
            return False
        if a.shape[-1] != 1 << self.log_cols:
            raise ValueError(f"rows of {a.shape[-1]} columns: {self.n} (whole) "
                             f"or {1 << self.log_cols} (a shard of sp "
                             f"{self.sp}) expected")
        return True

    def _transform(self, a, idx, inverse: bool) -> torch.Tensor:
        if not self._is_shard(a):
            return self.whole._transform(a, idx, inverse)
        idx = tuple(range(a.shape[-2])) if idx is None else tuple(idx)
        if len(idx) != a.shape[-2]:
            raise ValueError(f"{len(idx)} limb indices for {a.shape[-2]} rows")
        if a.numel() == 0:              # every rank of the group holds none
            return torch.empty_like(a)
        stages = self._stages[inverse]
        if inverse:
            a = self._local(a, idx, True)
        for peer, upper, w in stages:
            theirs = self._exchange(a, peer, peer,
                                    "intt cross" if inverse else "ntt cross")
            a = self._cross(a, theirs, idx, upper, w, inverse)
        return a if inverse else self._local(a, idx, False)

    def _local(self, a, idx, inverse: bool) -> torch.Tensor:
        """The shard's own N/sp-point sub-transform (K2/K3 on its tables)."""
        w = self.whole
        if a.device.type == "cpu":
            q, qinv = w.tabs(idx)[:2]
            sel = w._select(idx)
            if inverse:
                return _ntt_inv(a, self.itw.index_select(0, sel),
                                w.n_inv.index_select(0, sel)[:, None], q, qinv,
                                self.log_cols)
            return _ntt_fwd(a, self.tw.index_select(0, sel), q, qinv,
                            self.log_cols)
        batch = a.numel() // (a.shape[-1] * len(idx))
        return ntt_kernel.ntt_cuda(a, w._row_limb(idx, batch), w.q_vec,
                                   w.qinv_vec, self.itw if inverse else self.tw,
                                   w.n_inv, self.log_cols, inverse)

    def _cross(self, a, theirs, idx, upper: bool, w: torch.Tensor,
               inverse: bool) -> torch.Tensor:
        """One cross stage on this rank's half (the cross-stage kernel)."""
        whole = self.whole
        if a.device.type == "cpu":
            q, qinv = whole.tabs(idx)[:2]
            return ntt_cross_plain(a, theirs,
                                   w.index_select(0, whole._select(idx))[:, None],
                                   q, qinv, upper, inverse)
        batch = a.numel() // (a.shape[-1] * len(idx))
        return ntt_kernel.ntt_cross_cuda(a, theirs, whole._row_limb(idx, batch),
                                         whole.q_vec, whole.qinv_vec, w, upper,
                                         inverse)

    def _exchange(self, x: torch.Tensor, send_to: int, recv_from: int,
                  what: str) -> torch.Tensor:
        """x sent to global rank `send_to`, and a tensor of its shape
        received from `recv_from`, in one batch of point-to-point ops.
        Gloo moves host memory only: a CUDA tensor is staged through it."""
        x = x.contiguous()
        staged = x.device.type == "cuda" and dist.get_backend(self.group) == "gloo"
        out = x.cpu() if staged else x
        got = torch.empty_like(out)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, send_to, self.group),
                dist.P2POp(dist.irecv, got, recv_from, self.group)]):
            work.wait()
        c = self.comm.setdefault(what, [0, 0, 0])
        nbytes = x.numel() * x.element_size()
        c[0] += 1
        c[1] += nbytes
        c[2] += nbytes
        return got.to(x.device) if staged else got

    # ---- the Galois gather -----------------------------------------------

    def galois_perm(self, g: int) -> ShardPerm:
        """φ_g's permutation for whole rows and for this rank's shard."""
        g = g % (2 * self.n)
        got = self._perms.get(g)
        if got is None:
            dev = self.whole.device
            whole = torch.from_numpy(galois_perm_ntt(self.whole.log_n, g).copy()
                                     ).to(dev)
            src, dst, local = shard_galois(self.whole.log_n, g, self.sp, self.s)
            got = self._perms[g] = ShardPerm(whole, src, dst,
                                             torch.from_numpy(local.copy()).to(dev))
        return got

    def permute(self, x: torch.Tensor, perm: ShardPerm) -> torch.Tensor:
        """φ_g on NTT-domain rows, whole or this rank's shard: the source
        shard received from rank σ(s) (this one sent to σ⁻¹(s)), skipped
        where σ(s) = s, then gathered."""
        if not self._is_shard(x):
            return x.index_select(-1, perm.whole)
        if perm.src != self.s and x.numel():
            x = self._exchange(x, self._global(perm.dst), self._global(perm.src),
                               "galois")
        return x.index_select(-1, perm.local)


class CoeffShardedContext(CkksContext):
    """A CKKS context whose evaluator runs on one sp rank's column shards.

    Made like ``CkksContext`` from the parameters and seed, on every rank
    of the mesh: the secret key, the switching keys, encryption and
    decryption are the whole context's, on whole rows (every rank of one
    seed and one device type makes the same keys).  Its ``ntt`` is a
    ``CoeffShardedNtt`` on the mesh's sp group, its Galois permutations
    are ``ShardPerm``s, and its key switch reads the key's columns of the
    shard, so ``rotate``, ``keyswitch``, ``mul_plain`` and ``rescale``
    (and the key-switch and rescale pieces a limb-sharded step calls) run
    unchanged on a ciphertext's column shards (``sharding.shard_ct``), and
    on whole ciphertexts as the single device does.  Hoisted rotations
    are not carried over to shards.  Its NTT runs on column shards, so it
    takes only the butterfly route (``ntt_backend="butterfly"``)."""

    # its collectives (gloo, NCCL) are not captured in CUDA graphs: eager
    GRAPHS = False

    def __init__(self, params: CkksParams, device, mesh: Mesh, seed: int = 0,
                 **kw):
        if kw.get("ntt_backend", "butterfly") != "butterfly":
            raise ValueError(f"ntt_backend={kw['ntt_backend']!r}: an sp "
                             "context's NTT is the butterfly on column shards")
        self.mesh = mesh
        self._coeffs = None
        super().__init__(params, device, seed=seed, **kw)

    @property
    def ntt(self) -> CoeffShardedNtt:
        if self._coeffs is None:
            self._coeffs = CoeffShardedNtt(self.tables.ntt, self.mesh)
        return self._coeffs

    def galois_perm(self, g: int) -> ShardPerm:
        return self.ntt.galois_perm(g)

    def _permute(self, x: torch.Tensor, perm: ShardPerm) -> torch.Tensor:
        return self.ntt.permute(x, perm)

    def keyswitch(self, c1: torch.Tensor, level: int, swk: SwitchingKey):
        """The key switch of whole rows, or of a shard with the columns of
        the shard of the (whole) key, read in place."""
        if c1.shape[-1] == self.params.n:
            return super().keyswitch(c1, level, swk)
        if swk.level != level:
            raise ValueError(f"key of level {swk.level} used at level {level}")
        cols = self.ntt.cols
        return self._ks_core(self._decompose(c1, level), swk.d0[..., cols],
                             self.swk_d1(swk)[..., cols], level)


# ---------------------------------------------------------------------------
# the checks of the sp axis
# ---------------------------------------------------------------------------

CHECKS = ("ntt", "intt", "intt(ntt)", "galois +rot", "galois -rot",
          "keyswitch", "step")


def coeff_case(ctx: CoeffShardedContext, mesh: Mesh, level: int, ct: Ciphertext,
               pt: Plaintext, swk: SwitchingKey, rot: int = 1,
               batch: int = 1) -> dict:
    """One rank's part of the sp checks on `mesh` at `level` (every rank
    of the world calls it; `ctx` a ``CoeffShardedContext`` on `mesh`), on
    a batch of `batch` copies of the whole `ct` placed by
    ``batch_sharding``:

      ntt          the forward NTT of this rank's shard of c0;
      intt         the inverse NTT of the same shard;
      intt(ntt)    the inverse of the forward one;
      galois ±rot  φ_g of c0's shard for rotations rot and −rot;
      keyswitch    the rotated key switch of the JAX package's sp test,
                   keyswitch(φ_g(c1), level, swk), both halves;
      step         ``ShardedLayerStep``: rescale(rotate(mul_plain(ct, pt))).

    → {check: the gathered whole [2, B, rows, N] on every rank (the pair,
    or c0's result twice)}, with ``bytes`` (the step's tp collectives)
    and ``comm`` (this rank's sp transfers of the whole case)."""
    p = ctx.params
    lay = shd.batch_sharding(mesh, level + 1, batch)
    shape = (batch,) + tuple(ct.c0.shape)
    c0, c1 = (lay.take(c.expand(shape), mesh) for c in (ct.c0, ct.c1))
    step = shd.ShardedLayerStep(ctx, level, mesh)
    own = step.own_q
    perm = ctx.galois_perm(rot_to_galois(rot, p.log_n))
    perm_inv = ctx.galois_perm(rot_to_galois(-rot, p.log_n))
    ctx.ntt.comm.clear()
    fwd = ctx.ntt.ntt(c0, own)
    inv = ctx.ntt.intt(c0, own)
    back = ctx.ntt.intt(fwd, own)
    keys = step.shard_key(swk)
    ks = step.keyswitch(ctx._permute(c1, perm), *keys)
    out = step(c0, c1, step.shard_pt(pt.poly), perm, *keys)
    res = {}
    for name, a, b, layout in (
            ("ntt", fwd, None, lay), ("intt", inv, None, lay),
            ("intt(ntt)", back, None, lay),
            ("galois +rot", ctx._permute(c0, perm), None, lay),
            ("galois -rot", ctx._permute(c0, perm_inv), None, lay),
            ("keyswitch", *ks, lay), ("step", *out, step.out_layout(lay))):
        res[name] = shd.gather_stacked(torch.stack([a, a if b is None else b]),
                                       mesh, layout)
    res["bytes"] = dict(step.bytes)
    res["comm"] = {k: list(v) for k, v in ctx.ntt.comm.items()}
    return res


def coeff_reference(ctx: CkksContext, level: int, ct: Ciphertext,
                    pt: Plaintext, swk: SwitchingKey, rot: int = 1) -> dict:
    """The single device's results of ``coeff_case``'s checks on whole
    rows (of any context of the same seed): {check: [2, rows, N]};
    ``intt(ntt)`` is c0 itself."""
    p = ctx.params
    idx = p.q_idx(level)
    c0, c1 = ct.c0, ct.c1
    perm = ctx.galois_perm(rot_to_galois(rot, p.log_n))
    perm_inv = ctx.galois_perm(rot_to_galois(-rot, p.log_n))
    fwd = ctx.ntt.ntt(c0, idx)
    inv = ctx.ntt.intt(c0, idx)
    g0, g1 = ctx._permute(c0, perm), ctx._permute(c0, perm_inv)
    ks = ctx.keyswitch(ctx._permute(c1, perm), level, swk)
    out = ctx.rescale(ctx.rotate(ctx.mul_plain(ct, pt), rot))
    return {"ntt": torch.stack([fwd, fwd]),
            "intt": torch.stack([inv, inv]),
            "intt(ntt)": torch.stack([c0, c0]),
            "galois +rot": torch.stack([g0, g0]),
            "galois -rot": torch.stack([g1, g1]),
            "keyswitch": torch.stack(list(ks)),
            "step": torch.stack([out.c0, out.c1])}


def dryrun_coeffs(n_devices: int, sp: int, log_n: int = 8, levels: int = 7,
                  batch: int | None = None, device="cuda") -> dict:
    """The sp checks (``coeff_case``) on an n-rank mesh whose innermost
    axis is sp and whose other n/sp ranks factor as ``dryrun``'s: (dp,
    tp, sp), or (dcn, dp, tp, sp) where n/sp ≥ 8; at the JAX sp test's
    chain, at its top level and at level 2, rotation 1, a batch of
    dcn × dp copies by default.  Every rank holds each gathered result to
    the single device's (``coeff_reference`` on the same context's whole
    rows, residue for residue).  Runs in
    the current world, whose size must be n.  → {"digests": {"level: check":
    sha256 of the gathered pair}, "bytes": {collective or sp transfer:
    (payload, moved) of one step at the top level}, "comm": this rank's
    sp transfers of each level's checks}."""
    if n_devices != shd._world_size() or n_devices % sp:
        raise ValueError(f"dryrun_coeffs({n_devices}, sp {sp}) in a world of "
                         f"{shd._world_size()} ranks: start it under torchrun "
                         "or run_ranks, sp dividing n")
    dev = shd.local_device(device)
    m = n_devices // sp
    mesh = shd.build_mesh(shd.hybrid_mesh_shape(m) if m >= 8 else
                          shd.mesh_shape(m), sp=sp)
    params = CkksParams(log_n=log_n, logq=(45,) + (35,) * levels,
                        logp=(45, 45, 45, 45), log_scale=25, h=32)
    ctx = CoeffShardedContext(params, dev, mesh, seed=0)
    b = shd.batch_parts(mesh) if batch is None else batch
    rng = np.random.default_rng(0)
    top = params.max_level
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(rng.uniform(-1, 1, params.n),
                                               params.scale, top))
    g = rot_to_galois(1, log_n)
    digests, comm, moved = {}, {}, {}
    for level in (top, 2):
        c = ctx.drop_level(ct, top - level)
        pt = ctx.encoder.encode_coeffs(rng.uniform(-1, 1, 8), params.scale,
                                       level)
        swk = shd.share_galois_key(ctx, g, level)
        got = coeff_case(ctx, mesh, level, c, pt, swk, 1, b)
        want = coeff_reference(ctx, level, c, pt, swk, 1)
        for name in CHECKS:
            w = want[name][:, None].expand(got[name].shape)
            if not torch.equal(got[name], w):
                raise AssertionError(f"dryrun_coeffs level {level} {name}: the "
                                     "sharded result differs from the single "
                                     "device")
            digests[f"{level}: {name}"] = shd._ct_digest(
                Ciphertext(got[name][0], got[name][1], level=level))[2:]
        comm[level] = got["comm"]
        if level == top:
            step = shd.ShardedLayerStep(ctx, level, mesh)
            lay = shd.batch_sharding(mesh, level + 1, b)
            shape = (b,) + tuple(c.c0.shape)
            ctx.ntt.comm.clear()
            step(lay.take(c.c0.expand(shape), mesh),
                 lay.take(c.c1.expand(shape), mesh), step.shard_pt(pt.poly),
                 ctx.galois_perm(g), *step.shard_key(swk))
            moved = {**step.bytes, **{k: tuple(v[1:]) for k, v in
                                      ctx.ntt.comm.items()}}
    return dict(digests=digests, bytes=moved, comm=comm)
