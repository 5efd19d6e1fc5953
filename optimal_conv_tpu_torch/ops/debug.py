"""Per-stage decrypt oracles for the fused conv-BN-ReLU-bootstrap layer.

Counterpart of ``optimal_conv_tpu/ops/debug.py``.  The Go fork's
de-facto unit tests are decrypt-and-compare hooks between pipeline
stages (debug=true in evalConv_BNRelu_new: debugCtoS eval.go:610-631,
debugReLU :633-649, debugStoC :651-722, printed through printDebug's
precision stats).  `DebugOracle` reproduces that flow as a `debug_hook`
for `ops.pipeline.eval_conv_bn_relu`: each stage is decrypted and
compared against the plaintext mirror chain, restricted to the positions
the repack retains (outside them the homomorphic result legitimately
carries negacyclic pad garbage that the repack discards).

Golden coverage spans ALL kinds, driven by the layer's own repack maps
(debugStoC replays the identical rot_util mirrors):
  keep kinds    Conv, Conv_sparse, Conv_inside, StrConv_inside —
                want = relu(slots)·2^pow ⊙ ext_idx[ul]
  stride kinds  StrConv, StrConv_fast, StrConv_odd, StrConv_sparse,
                StrConv_sparse_full — want = apply_rot_maps(m_idx then
                r_idx) over the ReLU'd slot view
  trans         TransConv — single-stage extend maps (r_idx)
The caller provides the expected conv output in the combined
N-coefficient layout (for split-kernel/offset kinds: after the
even/odd X^{norm/4} interleave), as the Go fork's debug mode does
with its decrypt-after-conv reference vector.

The free functions (``precision_stats`` and the ``prt_mat`` family) are
numpy only and have the JAX package's source.
"""

from __future__ import annotations

import numpy as np

from ..ckks.context import CkksContext
from . import repack as rp
from .relu import relu_np

KEEP_KINDS = ("Conv", "Conv_sparse", "Conv_inside", "StrConv_inside")
STRIDE_KINDS = ("StrConv", "StrConv_fast", "StrConv_odd", "StrConv_sparse",
                "StrConv_sparse_full")


def precision_stats(want: np.ndarray, have: np.ndarray,
                    mask: np.ndarray | None = None,
                    distribution: bool = False) -> str:
    """log2-error stats (GetPrecisionStatsPlain,
    main.go:694-717).

    With distribution=True also reports the quartiles and a cumulative
    count table over integer log2-precision buckets, like Lattigo's
    PrecisionStats.String() that the reference prints after every
    conv/convReLU run (main.go:683-716)."""
    want = np.asarray(want, dtype=float).ravel()
    have = np.asarray(have, dtype=float).ravel()
    if mask is not None:
        sel = np.asarray(mask).ravel().astype(bool)
        want, have = want[sel], have[sel]
    err = np.abs(want - have) + 1e-300
    lg = -np.log2(err)
    line = (f"prec (log2): avg {lg.mean():6.2f}  min {lg.min():6.2f}  "
            f"max {lg.max():6.2f}")
    if not distribution:
        return line
    q1, med, q3 = np.percentile(lg, (25, 50, 75))
    line += f"  med {med:6.2f}  q1 {q1:6.2f}  q3 {q3:6.2f}"
    # cumulative distribution: how many values reach >= b bits
    lo = max(int(np.floor(lg.min())), int(np.floor(lg.mean())) - 8)
    hi = int(np.ceil(lg.mean())) + 4
    rows = []
    for b in range(lo, hi + 1):
        cnt = int(np.count_nonzero(lg >= b))
        if cnt == 0:
            break
        rows.append(f"  >={b:3d} bits: {cnt:8d} ({100.0*cnt/len(lg):5.1f}%)")
    return line + "\n" + "\n".join(rows)


# ---------------------------------------------------------------------------
# Matrix views of the position-major packed layout (the reference's
# prt_mat family, main.go:829-941): a packed vector holds
# `batch` contiguous channel entries per spatial position, row-major over
# a sqrt(len/batch)-wide grid; `norm` subsamples the channels (only every
# norm-th slot carries a real value in sparse packing).


def mat_view(vec: np.ndarray, batch: int, norm: int = 1) -> np.ndarray:
    """[row, row, batch//norm] dense view of a packed vector."""
    vec = np.asarray(vec)
    row = int(np.sqrt(len(vec) // batch))
    return vec[: row * row * batch].reshape(row, row, batch)[:, :, ::norm]


def prt_mat(vec: np.ndarray, batch: int, show: int = 3, norm: int = 1,
            half: bool = False) -> None:
    """Print (i, j)-position channel rows; show=0 prints all, otherwise
    only the show-wide corners (prt_mat/prt_mat_norm,
    main.go:829-870)."""
    m = mat_view(vec, batch, norm)
    row = m.shape[0] // 2 if half else m.shape[0]
    for j in range(1, row + 1):
        for k in range(1, row + 1):
            if show and not ((j <= show or j > row - show)
                             and (k <= show or k > row - show)):
                continue
            vals = " ".join(f"{v:9.6f}" for v in m[j - 1, k - 1])
            print(f"({j}, {k}): [{vals}]")
    print(flush=True)


def prt_mat_step(vec: np.ndarray, batch: int, norm: int, step: int,
                 start: int = 0, show: int = 3, half: bool = False) -> None:
    """Print only the step-grid positions (the fast regime's dilated
    features; prt_mat_norm_step, main.go:875-898)."""
    m = mat_view(vec, batch, norm)
    row = m.shape[0] // 2 if half else m.shape[0]
    for j in range(1, row + 1):
        for k in range(1, row + 1):
            if show and not ((j <= show * step or j > row - show * step)
                             and (k <= show * step or k > row - show * step)):
                continue
            if (j - start) % step or (k - start) % step:
                continue
            vals = " ".join(f"{v:9.6f}" for v in m[j - 1, k - 1])
            print(f"({(j - start) // step + 1}, {(k - start) // step + 1}): "
                  f"[{vals}]")
    print(flush=True)


def mat_one(vec: np.ndarray, batch: int, sj: int, sk: int,
            norm: int = 1) -> np.ndarray:
    """Channel vector at the 1-based position (sj, sk)
    (prt_mat_one/prt_mat_one_norm, main.go:902-940)."""
    return mat_view(vec, batch, norm)[sj - 1, sk - 1]


class DebugOracle:
    """debug_hook comparing each pipeline stage to the plaintext mirror.

    plain_conv_cfs: expected conv+BN output as the N-coefficient layout
    vector, in unscaled units (the values the layer would decode to if
    decrypted right after the conv, times 2^pow).
    maps: the layer's LayerMaps — the same tables the homomorphic repack
    consumes drive the mirror (pass the ones given to the pipeline).
    """

    def __init__(self, ctx: CkksContext, in_wid: int, kp_wid: int, kind: str,
                 pow_: float, log_sparse: int, plain_conv_cfs: np.ndarray,
                 maps=None):
        self.ctx = ctx
        self.in_wid = in_wid
        self.kp_wid = kp_wid
        self.kind = kind
        self.pow = pow_
        self.ls = log_sparse
        self.maps = maps
        self.history: list[tuple[str, float | None]] = []
        p = ctx.params
        self.n = p.n
        self.slots = p.n // 2
        self.logn = p.log_n
        self.cfs = np.asarray(plain_conv_cfs, dtype=float) / 2.0 ** pow_
        self.brv = np.array([rp.reverse_bits(i, self.logn - 1)
                             for i in range(self.slots)])
        if kind in KEEP_KINDS:
            self.mode = "keep"
        elif kind in STRIDE_KINDS:
            self.mode = "stride"
        elif kind == "TransConv":
            self.mode = "trans"
        else:
            raise ValueError(f"unknown kind {kind}")

        # ---- expected slot views of the conv output ---------------------
        if self.ls == 0:
            self.w_slots = [self.cfs[: self.slots][self.brv],
                            self.cfs[self.slots:][self.brv]]
        else:
            n_sub = self.slots >> self.ls
            cp = self.cfs[:: 1 << self.ls]            # subring coeffs
            brv_s = np.array([rp.reverse_bits(i, self.logn - 1 - self.ls)
                              for i in range(n_sub)])
            period = np.concatenate([cp[brv_s], cp[brv_s + n_sub]])
            self.w_slots = [np.tile(period, self.slots // (2 * n_sub)), None]

        # ---- repack mirror + valid-position masks -----------------------
        # golden iff the layer's maps are available (the keep fallback for
        # plain Conv kinds regenerates them)
        self.golden = True
        self.keep: list = [None, None]
        if self.mode == "keep":
            if maps is not None and maps.ext_idx is not None:
                self.keep = [maps.ext_idx[0],
                             maps.ext_idx[1] if self.ls == 0 else None]
            elif kind in ("Conv", "Conv_sparse"):
                if self.ls == 0:
                    self.keep = [rp.gen_keep_vec(self.slots, in_wid, kp_wid,
                                                 ul) for ul in (0, 1)]
                else:
                    self.keep = [rp.gen_keep_vec_sparse(
                        self.slots, in_wid, kp_wid, self.ls), None]
            else:
                self.golden = False
        else:
            if maps is None or maps.r_idx is None:
                self.golden = False
            else:
                # valid conv positions = union of the first-stage masks
                for ul in (0, 1):
                    if self.ls > 0 and ul == 1:
                        continue
                    m = maps.m_idx if ul == 0 else maps.m_idx_l
                    r = maps.r_idx if ul == 0 else maps.r_idx_l
                    src = m if m is not None else r
                    if src is None:
                        continue
                    acc = np.zeros(self.slots)
                    for mask in src.values():
                        acc = acc + np.asarray(mask)
                    self.keep[ul] = (acc > 0).astype(np.int64)

    # ------------------------------------------------------------------

    def _repack_mirror(self, ul: int, relu_slots: np.ndarray):
        """Replay the layer's own repack maps on the plain slot view
        (debugStoC, eval.go:651-722)."""
        m = self.maps
        if self.mode == "keep":
            return relu_slots * self.keep[ul]
        m_idx = m.m_idx if ul == 0 else m.m_idx_l
        r_idx = m.r_idx if ul == 0 else m.r_idx_l
        if r_idx is None:
            return None
        out = relu_slots
        if self.mode == "stride" and m_idx is not None:
            out = rp.apply_rot_maps(out, m_idx)
        return rp.apply_rot_maps(out, r_idx)

    def expected_output(self) -> np.ndarray | None:
        """The N coefficients the layer's StoC should decode to: the
        repack mirror of relu(conv)·2^pow, back in the coefficient
        layout (None where the kind has no golden)."""
        if not self.golden:
            return None
        r = [self._repack_mirror(ul, relu_np(w) * 2.0 ** self.pow)
             if w is not None else None
             for ul, w in enumerate(self.w_slots)]
        want = np.zeros(self.n)
        if self.ls == 0 and r[1] is not None:
            want[: self.slots] = r[0][self.brv]
            want[self.slots:] = r[1][self.brv]
        elif r[0] is not None:
            n_sub = self.slots >> self.ls
            brv_s = np.array([rp.reverse_bits(i, self.logn - 1 - self.ls)
                              for i in range(n_sub)])
            sub = np.zeros(2 * n_sub)
            sub[brv_s] = r[0][:n_sub]
            sub[brv_s + n_sub] = r[0][n_sub: 2 * n_sub]
            want[:: 1 << self.ls] = sub
        else:
            return None
        return want

    def _info(self, ct) -> str:
        return f"lv={ct.level} scale=2^{np.log2(ct.scale):.1f}"

    def _report(self, stage: str, want, have, mask=None, ct=None):
        head = f"[debug {stage:6s}]"
        if ct is not None:
            head += f" {self._info(ct)}"
        if want is None:
            have = np.asarray(have)
            print(f"{head}  |have|max={np.max(np.abs(have)):.3g} "
                  "(no golden for this kind)", flush=True)
            self.history.append((stage, None))
        else:
            stats = precision_stats(want, have, mask)
            print(f"{head}  {stats}", flush=True)
            self.history.append((stage,
                                 float(stats.split("avg")[1].split()[0])))

    def __call__(self, stage: str, data):
        ctx = self.ctx
        if stage == "conv":
            have = ctx.decrypt_decode_coeffs(data)
            want = mask = None
            if self.golden and self.keep[0] is not None:
                want = self.cfs
                mask = np.zeros(self.n)
                if self.ls == 0:
                    mask[: self.slots][self.brv] = self.keep[0]
                    if self.keep[1] is not None:
                        mask[self.slots:][self.brv] = self.keep[1]
                else:
                    sub = np.zeros(self.slots >> (self.ls - 1))
                    n_sub = self.slots >> self.ls
                    brv_s = np.array(
                        [rp.reverse_bits(i, self.logn - 1 - self.ls)
                         for i in range(n_sub)])
                    sub[brv_s] = self.keep[0][:n_sub]
                    sub[brv_s + n_sub] = self.keep[0][n_sub: 2 * n_sub]
                    mask[:: 1 << self.ls] = sub
            self._report(stage, want, have, mask, ct=data)
            return
        if stage in ("ctos", "relu", "repack"):
            for ul, ct in enumerate(data):
                if ct is None:
                    continue
                have = ctx.decrypt_decode_slots(ct).real
                if len(have) < self.slots:           # sparse bootstrapper
                    have = np.tile(have, self.slots // len(have))
                want = mask = None
                if self.golden:
                    want = self.w_slots[ul]
                    if want is not None:
                        if stage == "relu":
                            want = relu_np(want) * 2.0 ** self.pow
                            mask = self.keep[ul]
                        elif stage == "repack":
                            want = self._repack_mirror(
                                ul, relu_np(want) * 2.0 ** self.pow)
                        else:
                            mask = self.keep[ul]
                self._report(f"{stage}[{ul}]", want, have, mask, ct=ct)
            return
        if stage == "stoc":
            have = ctx.decrypt_decode_coeffs(data)
            self._report(stage, self.expected_output(), have, ct=data)
            return
        print(f"[debug {stage}] (unknown stage)", flush=True)
