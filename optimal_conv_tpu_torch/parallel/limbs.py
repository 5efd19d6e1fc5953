"""The limb-sharded CKKS context: the whole evaluator on one rank's limbs.

On the TPU the JAX package commits a ciphertext's RNS-limb axis to the
mesh's tp axis (``shard_ct``) and GSPMD carries that sharding through
every evaluator op of a fused layer.  Here each rank of the tp group
holds a ``LimbShardedContext``: the evaluator of ``ckks/context.py``, run
unchanged on the rank's own limbs, with the three functions that cross
limbs overridden by their collectives:

  * ``_decompose`` (ModUp, before every key switch; once a hoist for
    hoisted rotations): all-gather of the coefficient-form c1, then each
    rank extends every digit to its own Q and P limbs.  Every rank runs
    the float32 correction count on the same whole integers in the same
    order, so the digits are the single device's bit for bit;
  * ``_mod_down_many`` (after every key switch; once a giant for the
    lazy BSGS sums): all-gather of the coefficient-form P rows, all the
    accumulators of one call in one collective;
  * ``_limb_coeffs`` (the rescale's top limb, ModRaise's limb 0):
    broadcast of the limb's coefficient form by its owner, both halves
    in one collective.

Everything else is limb-local: NTTs, products, the Galois gather,
plaintexts (the context's encoder makes only the rank's rows) and keys.
A key is made by each rank for its own limbs from the key's seed, with
no collective (``gen_switching_key``; the uniform half drawn at its
counters in the whole key, ``core/threefry.py``), so the per-rank key
caches may evict independently: a key lookup never waits on another
rank.  Every rank calls every collective in the same order, a rank that
holds no limb at a level included.

The placement (``LimbPlacement``) is fixed per global limb: Q limb i on
tp rank i mod tp, P limb j on rank (tp − 1 − j) mod tp.  The ranks stay
within one Q limb of each other at every level, a rank's rows of level ℓ
are a prefix of its rows of any higher level (``drop_level`` and the
rescale move no data but the top limb), and the P limbs go first to the
ranks that the Q limbs leave short.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..ckks.context import CkksContext
from ..ckks.params import CkksParams
from ..ckks.types import Ciphertext
from .sharding import Mesh, _all_gather


class LimbPlacement:
    """Which tp rank holds each global limb: Q limb i on rank i mod tp,
    P limb j (the j-th special prime) on rank (tp − 1 − j) mod tp."""

    def __init__(self, params: CkksParams, tp: int):
        if tp < 1:
            raise ValueError(f"tp {tp}")
        self.params, self.tp = params, tp
        pidx = params.p_idx()
        self._p = tuple(tuple(pidx[j] for j in range(params.num_p)
                              if (tp - 1 - j) % tp == r) for r in range(tp))

    def q_owner(self, limb: int) -> int:
        return limb % self.tp

    def q_rows(self, level: int, rank: int) -> tuple[int, ...]:
        """The Q limbs of `level` on `rank`, increasing."""
        return tuple(range(rank, level + 1, self.tp))

    def p_rows(self, rank: int) -> tuple[int, ...]:
        return self._p[rank]

    def rows(self, rank: int, level: int, qp: bool = False) -> tuple[int, ...]:
        """`rank`'s Q limbs of `level`, then with `qp` its P limbs."""
        q = self.q_rows(level, rank)
        return q + self._p[rank] if qp else q

    def q_position(self, limb: int) -> int:
        """The row of Q limb `limb` on its owner."""
        return limb // self.tp

    def counts(self, level: int) -> list[tuple[int, int]]:
        """(Q limbs, P limbs) of each rank at `level`."""
        return [(len(self.q_rows(level, r)), len(self._p[r]))
                for r in range(self.tp)]

    def take(self, t: torch.Tensor, level: int, rank: int) -> torch.Tensor:
        """`rank`'s rows of a whole [..., level+1, N] tensor."""
        idx = self.q_rows(level, rank)
        return t.index_select(-2, torch.tensor(idx, dtype=torch.int64,
                                               device=t.device))


class LimbShardedContext(CkksContext):
    """One rank's part of a CKKS context whose limbs are split over the
    mesh's tp axis (``LimbPlacement``); every tp rank holds one, made
    from the same parameters and seed.  Without a world (a mesh of one
    rank) it is the single device's context with the same arithmetic.

    ``encrypt`` gives the rank's rows of the ciphertext the whole context
    of the same seed makes; ``shard_ct`` takes them from a whole
    ciphertext; ``gather_ct`` (a collective) gives the whole one back.
    Decryption gathers first, so every rank must call it.  ``comm``
    counts the collectives by kind: [calls, payload bytes, bytes moved
    (the padding of uneven shards included)]."""

    # its collectives (gloo, NCCL) are not captured in CUDA graphs: eager
    GRAPHS = False

    def __init__(self, params: CkksParams, device, mesh: Mesh, seed: int = 0,
                 **kw):
        tp = mesh.size("tp")
        if mesh.device_mesh is None and tp > 1:
            raise ValueError("a tp axis of several ranks needs a "
                             "torch.distributed world (init_distributed)")
        self.mesh, self.tp, self.rank = mesh, tp, mesh.coord("tp")
        self.group = mesh.group("tp")
        self.placement = LimbPlacement(params, tp)
        self._q_cache: dict = {}
        self._order: dict = {}
        self.comm: dict = {}
        super().__init__(params, device, seed=seed, **kw)

    # ---- this rank's limbs ---------------------------------------------

    def q_rows(self, level: int) -> tuple[int, ...]:
        got = self._q_cache.get(level)
        if got is None:
            got = self._q_cache[level] = self.placement.q_rows(level, self.rank)
        return got

    def p_rows(self) -> tuple[int, ...]:
        return self.placement.p_rows(self.rank)

    def _encoder_rows(self):
        return functools.partial(self.placement.rows, self.rank)

    def shard_ct(self, ct: Ciphertext) -> Ciphertext:
        """This rank's rows of a whole ciphertext (or batch of them)."""
        lv, r = ct.level, self.rank
        return Ciphertext(self.placement.take(ct.c0, lv, r),
                          self.placement.take(ct.c1, lv, r), level=lv,
                          scale=ct.scale)

    def gather_ct(self, ct: Ciphertext) -> Ciphertext:
        """The whole ciphertext on every rank (a collective)."""
        rows = [self.placement.q_rows(ct.level, r) for r in range(self.tp)]
        c = self._gather(torch.stack([ct.c0, ct.c1]), rows, "gather_ct")
        return Ciphertext(c[0], c[1], level=ct.level, scale=ct.scale)

    def decrypt_to_coeffs(self, ct: Ciphertext):
        """Gathers the whole ciphertext first (a collective), then
        decrypts it: a shard is never decrypted alone."""
        return super().decrypt_to_coeffs(self.gather_ct(ct))

    # ---- the collectives -------------------------------------------------

    def _log(self, what: str, payload: int, moved: int) -> None:
        c = self.comm.setdefault(what, [0, 0, 0])
        c[0] += 1
        c[1] += payload
        c[2] += moved

    def _gather(self, x: torch.Tensor, rows_by_rank, what: str) -> torch.Tensor:
        """All-gather along dim -2 of every rank's rows `rows_by_rank[r]`,
        → the rows in increasing global order."""
        if self.group is None:
            return x
        got: dict = {}
        y = _all_gather(x, self.group, [len(r) for r in rows_by_rank], -2,
                        got, what)
        if what in got:
            self._log(what, *got[what])
        key = tuple(rows_by_rank)
        if key not in self._order:
            flat = [g for r in rows_by_rank for g in r]
            perm = sorted(range(len(flat)), key=flat.__getitem__)
            self._order[key] = (None if perm == list(range(len(flat)))
                                else torch.tensor(perm, dtype=torch.int64,
                                                  device=self.device))
        order = self._order[key]
        return y if order is None else y.index_select(-2, order)

    def _decompose(self, c1: torch.Tensor, level: int) -> torch.Tensor:
        """ModUp: the whole c1 gathered in coefficient form, its digits
        extended to this rank's Q and P limbs."""
        p = self.params
        c1c = self.ntt.intt(c1, self.q_rows(level))
        rows = [self.placement.q_rows(level, r) for r in range(self.tp)]
        whole = self._gather(c1c, rows, "c1 all_gather")
        targets = self.qp_rows(level)
        if not targets:
            return whole.new_zeros(tuple(whole.shape[:-2])
                                   + (len(p.digits(level)), 0, p.n))
        return self.tables.digit_extender(level, targets).extend_digits(whole)

    def _mod_down_many(self, accs, level: int) -> list:
        """The P rows of every accumulator gathered in one collective, each
        divided by P on this rank's Q limbs."""
        idx = self.q_rows(level)
        nq = len(idx)
        acc_p = self.ntt.intt(torch.stack([a[..., nq:, :] for a in accs]),
                              self.p_rows())
        rows = [self.placement.p_rows(r) for r in range(self.tp)]
        acc_p = self._gather(acc_p, rows, "P all_gather")
        if not nq:
            return [a[..., :0, :] for a in accs]
        return [self._mod_down_limbs(a[..., :nq, :], acc_p[k], level, idx)
                for k, a in enumerate(accs)]

    def _limb_coeffs(self, c0: torch.Tensor, c1: torch.Tensor, limb: int):
        """Q limb `limb` of both halves in coefficient form, broadcast by
        its owner in one collective."""
        owner = self.placement.q_owner(limb)
        lead = tuple(torch.broadcast_shapes(c0.shape[:-2], c1.shape[:-2]))
        if self.rank == owner:
            k = self.placement.q_position(limb)
            t = self.ntt.intt(torch.stack([c[..., k:k + 1, :].expand(
                lead + (1, self.params.n)) for c in (c0, c1)]), (limb,))
        else:
            t = c0.new_empty((2,) + lead + (1, self.params.n))
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, owner),
                           group=self.group)
            self._log("limb broadcast", t.numel() * 8,
                      t.numel() * 8 * (self.tp - 1))
        return t[0], t[1]
