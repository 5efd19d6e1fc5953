"""Slot-repacking index generators and their plaintext mirrors.

Replaces ``rot_util.go`` of the reference (SURVEY.md R19/R20): the
mask/rotation tables that crop, stride-compress, or extend the
bit-reversed slot layout between the bootstrap halves (CtoS → ReLU →
*repack* → StoC), plus pure-numpy mirrors of the same permutations used
as the executable spec in tests (the reference's de-facto unit tests,
eval.go:651-722).

All indices live in the bit-reversed slot space produced by the
homomorphic DFT (see ckks/bootstrap.py).  Functions return
``{rotation: 0/1 mask}`` dicts consumed by masked-rotate-accumulate
(ops/pipeline.ext_ctxt / ext_double_ctxt / keep_ctxt).

Citations map each generator to its reference twin:
  gen_keep_vec         rot_util.go:141   crop-keep (full pack)
  gen_keep_vec_sparse  rot_util.go:179   crop-keep (sparse pack)
  gen_keep_vec_stride  rot_util.go:226   strided keep (fast/inside kinds)
  gen_comprs_full      rot_util.go:428   1-stage stride compression
  gen_comprs_fast      rot_util.go:498   2-stage (BSGS) compression
  gen_comprs_sparse    rot_util.go:557   sparse/full compression w/ 8|4|1
                                          block split by batch:wid ratio
"""

from __future__ import annotations

import numpy as np


def reverse_bits(num: int, width: int) -> int:
    out = 0
    for _ in range(width):
        out = (out << 1) | (num & 1)
        num >>= 1
    return out


def lrot(a: np.ndarray, r: int) -> np.ndarray:
    return np.roll(a, -r)


def rrot(a: np.ndarray, r: int) -> np.ndarray:
    return np.roll(a, r)


# ---------------------------------------------------------------------------
# keep-mask generators
# ---------------------------------------------------------------------------

def gen_keep_vec(vec_size: int, in_wid: int, kp_wid: int, ul: int) -> np.ndarray:
    """0/1 keep mask for the valid kp_wid² region (bit-reversed space)."""
    log_n = (2 * vec_size).bit_length() - 1
    idx = np.zeros(vec_size, dtype=np.int64)
    batch = 2 * vec_size // (in_wid * in_wid)
    if kp_wid < in_wid // 2:
        raise ValueError("keep width too small (< in_wid/2)")
    if ul == 0:
        i_range = range(in_wid // 2)
    else:
        i_range = range(kp_wid - in_wid // 2)
    for i in i_range:
        for j in range(kp_wid):
            base = in_wid * batch * i + batch * j
            for b in range(batch):
                idx[reverse_bits(base + b, log_n - 1)] = 1
    return idx


def gen_keep_vec_sparse(vec_size: int, in_wid: int, kp_wid: int,
                        log_sparse: int) -> np.ndarray:
    """Sparse-pack keep mask: up+low halves folded in one ct, values
    replicated across the sparse copies (rot_util.go:179-218)."""
    log_n = (2 * vec_size).bit_length() - 1
    idx = np.zeros(vec_size, dtype=np.int64)
    batch = 2 * vec_size // (in_wid * in_wid)
    sparsity = 1 << log_sparse
    if sparsity == 1:
        raise ValueError("full packing unsupported here (use gen_keep_vec)")
    if kp_wid < in_wid // 2:
        raise ValueError("keep width too small (< in_wid/2)")
    for i in range(in_wid // 2):
        for j in range(kp_wid):
            for b in range(batch // sparsity):
                idx[reverse_bits(in_wid * batch * i + batch * j + b * sparsity,
                                 log_n - 1)] = 1
    for i in range(kp_wid - in_wid // 2):
        for j in range(kp_wid):
            for b in range(batch // sparsity):
                idx[reverse_bits(in_wid * batch * i + batch * j + b * sparsity,
                                 log_n - 1) + vec_size // sparsity] = 1
    post_slot = 2 * vec_size // sparsity
    for k in range(1, sparsity // 2):
        idx[post_slot * k: post_slot * (k + 1)] = idx[:post_slot]
    return idx


def gen_keep_vec_stride(vec_size: int, in_wid: int, kp_wid: int, step: int,
                        ul: int, raw_in_wid_odd: bool) -> np.ndarray:
    """Keep only the strided outputs (rot_util.go:226-267)."""
    log_n = (2 * vec_size).bit_length() - 1
    idx = np.zeros(vec_size, dtype=np.int64)
    batch = 2 * vec_size // (in_wid * in_wid)
    init = 0 if raw_in_wid_odd else step - 1
    for i in range(kp_wid):
        row = init + i * step
        if ul == 0 and row < in_wid // 2:
            for j in range(kp_wid):
                for b in range(batch):
                    idx[reverse_bits(in_wid * batch * row
                                     + batch * (j * step + init) + b,
                                     log_n - 1)] = 1
        elif ul == 1 and row >= in_wid // 2:
            for j in range(kp_wid):
                for b in range(batch):
                    idx[reverse_bits(in_wid * batch * (row - in_wid // 2)
                                     + batch * (j * step + init) + b,
                                     log_n - 1)] = 1
    return idx


# ---------------------------------------------------------------------------
# compression (strided-conv repack) generators
# ---------------------------------------------------------------------------

def gen_comprs_full(vec_size: int, in_wid: int, kp_wid: int, pos: int,
                    ul: int) -> dict[int, np.ndarray]:
    """Single-stage masked-rotate map for stride compression
    (rot_util.go:428-492)."""
    r_idx: dict[int, np.ndarray] = {}
    batch = 2 * vec_size // (in_wid * in_wid)
    if kp_wid < in_wid // 2:
        raise ValueError("keep width too small")
    pos = reverse_bits(pos, 2)
    min_wid = in_wid // 4
    if in_wid % 4 != 0:
        raise ValueError("input width not divisible by 4")
    log_in_wid = (in_wid - 1).bit_length()
    for j in range(2 * min_wid):
        tmp = np.zeros(vec_size, dtype=np.int64)
        any_set = False
        for b in range(batch):
            for i in range(min_wid):
                keep = reverse_bits(in_wid // 2 + j, log_in_wid) < kp_wid
                if ul == 1:
                    keep = keep and reverse_bits(3 * min_wid + i,
                                                 log_in_wid - 1) < kp_wid - in_wid // 2
                if keep:
                    tmp[2 * min_wid * in_wid * b + 2 * min_wid * j + i
                        + in_wid * min_wid + min_wid] = 1
                    any_set = True
        rot = j * min_wid - 2 * pos * min_wid * min_wid + min_wid + in_wid * min_wid
        # all-zero masks contribute nothing to the masked-rotate sum but
        # each costs a homomorphic rotation in ext_ctxt — drop them
        # (parity with the mirror is unchanged: apply_rot_maps sums
        # mask·rot terms, and a zero mask is the additive identity)
        if any_set:
            r_idx[rot] = tmp
    return r_idx


def gen_comprs_fast(vec_size: int, in_wid: int, kp_wid: int, pos: int,
                    ul: int) -> tuple[dict, dict]:
    """Two-stage (BSGS) compression maps (rot_util.go:498-548)."""
    m_idx: dict[int, np.ndarray] = {}
    r_idx: dict[int, np.ndarray] = {}
    batch = 2 * vec_size // (in_wid * in_wid)
    if kp_wid < in_wid // 2:
        raise ValueError("keep width too small")
    pos = reverse_bits(pos, 2)
    min_wid = in_wid // 4
    if in_wid % 4 != 0:
        raise ValueError("input width not divisible by 4")
    log_in_wid = (in_wid - 1).bit_length()
    for j in range(2 * min_wid):
        tmp = np.zeros(vec_size, dtype=np.int64)
        for b in range(batch):
            for i in range(min_wid):
                ok_j = reverse_bits(in_wid // 2 + j, log_in_wid) < kp_wid
                if ul == 0 and ok_j:
                    tmp[2 * min_wid * in_wid * b + 2 * min_wid * j + i
                        + in_wid * min_wid + min_wid] = 1
                if ul == 1 and ok_j and \
                        reverse_bits(min_wid + i, log_in_wid - 1) < kp_wid - in_wid // 2:
                    tmp[2 * min_wid * in_wid * b + 2 * min_wid * j + i
                        + in_wid * min_wid + min_wid] = 1
        m_idx[j * min_wid - 2 * min_wid * min_wid + min_wid] = tmp
    for b in range(batch):
        tmp = np.zeros(vec_size, dtype=np.int64)
        for j in range(2 * min_wid):
            for i in range(min_wid):
                tmp[2 * min_wid * in_wid * b + 3 * in_wid // 2 * min_wid
                    + j * min_wid + i] = 1
        r_idx[3 * b * min_wid * in_wid // 2 - pos * min_wid * in_wid // 2 * batch
              + 3 * min_wid * in_wid // 2] = tmp
    return m_idx, r_idx


def gen_comprs_sparse(vec_size: int, in_wid: int, kp_wid: int, log_sparse: int,
                      ul: int, pos: int) -> tuple[dict, dict]:
    """Sparse / full-pack compression maps with the 8×/4×/1× block split
    (rot_util.go:557-722)."""
    m_idx: dict[int, np.ndarray] = {}
    r_idx: dict[int, np.ndarray] = {}
    batch = 2 * vec_size // (in_wid * in_wid * (1 << log_sparse))
    min_wid = in_wid // 2
    if in_wid % 2 != 0:
        raise ValueError("input width not divisible by 2")
    log_in_wid = (in_wid - 1).bit_length()

    if log_sparse != 0:
        if pos != 0:
            raise ValueError("pos != 0 unsupported for log_sparse != 0")
        rep = 1 << (log_sparse - 1)
        for j in range(min_wid):
            tmp = np.zeros(vec_size, dtype=np.int64)
            for b in range(batch):
                for i in range(min_wid // 2):
                    for k in range(2):
                        if reverse_bits(j, log_in_wid - 1) < kp_wid and \
                                (reverse_bits(i, log_in_wid - 2)
                                 + k * min_wid // 2) < kp_wid:
                            tmp[k * in_wid * min_wid * batch
                                + in_wid * in_wid * b // 2
                                + in_wid * j // 2 + i] = 1
            blk = vec_size // rep
            for k in range(1, rep):
                tmp[k * blk:(k + 1) * blk] = tmp[:blk]
            m_idx[j * min_wid // 2] = tmp
        for b in range(batch):
            tmp = np.zeros(vec_size, dtype=np.int64)
            for j in range(min_wid):
                for i in range(min_wid // 2):
                    for k in range(2):
                        tmp[k * in_wid * min_wid * batch + b * in_wid * in_wid // 2
                            + j * min_wid // 2 + i] = 1
            blk = vec_size // rep
            for k in range(1, rep):
                tmp[k * blk:(k + 1) * blk] = tmp[:blk]
            r_idx[3 * b * min_wid * min_wid // 2] = tmp
        return m_idx, r_idx

    # full packing: block split by batch:width ratio
    if batch > 8 * min_wid:
        bks = 8
    elif batch > 4 * min_wid:
        bks = 4
    else:
        bks = 1
    for j in range(min_wid):
        for bk in range(bks):
            tmp = np.zeros(vec_size, dtype=np.int64)
            for b in range(batch // bks):
                for i in range(min_wid // 2):
                    ok_j = reverse_bits(j, log_in_wid - 1) < kp_wid
                    if ul == 0:
                        ok = ok_j and reverse_bits(i, log_in_wid - 2) < kp_wid
                    else:
                        ok = ok_j and (reverse_bits(i, log_in_wid - 2)
                                       + min_wid // 2) < kp_wid
                    if ok:
                        tmp[bks * in_wid * min_wid * b + bk * min_wid * in_wid
                            + min_wid * j + i] = 1
            if bks > 1:
                rot = j * min_wid // 2 + (bks - 1) * bk * min_wid * min_wid // 2
            else:
                rot = j * min_wid // 2
            if rot in m_idx:
                m_idx[rot] = m_idx[rot] + tmp
            else:
                m_idx[rot] = tmp
    for b in range(batch // bks):
        tmp = np.zeros(vec_size, dtype=np.int64)
        for bk in range(bks):
            for j in range(min_wid):
                for i in range(min_wid // 2):
                    tmp[bks * b * in_wid * min_wid + bk * min_wid * min_wid // 2
                        + j * min_wid // 2 + i] = 1
        rot = 3 * b * bks * min_wid * min_wid // 2 \
            - reverse_bits(pos, 2) * batch * min_wid * min_wid // 2
        r_idx[rot] = tmp
    return m_idx, r_idx


# ---------------------------------------------------------------------------
# extension (transposed-conv repack) generators
# ---------------------------------------------------------------------------
#
# The reference's extend generators were deleted upstream (rot_util.go has
# only the compress family left; the TransConv kind in evalConv_BNRelu_new
# still dispatches to ext_ctxt with extension maps that nothing builds —
# eval.go:494).  We reconstruct them as the EXACT inverses
# of the compression maps: a masked-rotate-accumulate Σ_r lrot(x⊙m_r, r)
# moves source s (m_r[s]=1) to s−r, so its inverse is Σ_r lrot(y⊙m'_r, −r)
# with the mask carried to the destination side, m'_r = lrot(m_r, r).
# Injectivity of the forward map (disjoint destinations — asserted) makes
# the inversion exact.


def invert_rot_maps(maps: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """Inverse of one masked-rotate-accumulate stage."""
    dest_cover = None
    out: dict[int, np.ndarray] = {}
    for rot, mask in maps.items():
        moved = lrot(mask, rot)
        dest_cover = moved if dest_cover is None else dest_cover + moved
        out[-rot] = out.get(-rot, 0) + moved
    # an empty forward map (e.g. comprs_full ul=1 with kp_wid == in_wid/2
    # — the upper region keeps nothing) inverts to the empty map
    assert dest_cover is None or dest_cover.max() <= 1, \
        "forward map not injective — cannot invert"
    return out


def gen_extend_full(vec_size: int, in_wid: int, kp_wid: int, pos: int,
                    ul: int) -> dict[int, np.ndarray]:
    """Single-stage extension map: inverse of gen_comprs_full — scatter a
    stride-compressed layout back onto the 2× grid (the TransConv
    repack)."""
    return invert_rot_maps(gen_comprs_full(vec_size, in_wid, kp_wid, pos, ul))


def gen_extend_fast(vec_size: int, in_wid: int, kp_wid: int, pos: int,
                    ul: int) -> tuple[dict, dict]:
    """Two-stage (BSGS) extension maps: inverse of gen_comprs_fast with
    the stage order swapped (inv(m∘r) = inv(r)∘inv(m))."""
    m_idx, r_idx = gen_comprs_fast(vec_size, in_wid, kp_wid, pos, ul)
    return invert_rot_maps(r_idx), invert_rot_maps(m_idx)


def gen_extend_sparse(vec_size: int, in_wid: int, kp_wid: int,
                      log_sparse: int, ul: int, pos: int) -> tuple[dict, dict]:
    """Inverse of gen_comprs_sparse (sparse/full-pack compression)."""
    m_idx, r_idx = gen_comprs_sparse(vec_size, in_wid, kp_wid, log_sparse,
                                     ul, pos)
    return invert_rot_maps(r_idx), invert_rot_maps(m_idx)


# ---------------------------------------------------------------------------
# plaintext mirrors (executable spec; reference rot_util.go:35-136,277-422)
# ---------------------------------------------------------------------------

def keep_vec(inp: np.ndarray, in_wid: int, kp_wid: int, ul: int) -> np.ndarray:
    return inp * gen_keep_vec(len(inp), in_wid, kp_wid, ul)


def keep_vec_sparse(inp: np.ndarray, in_wid: int, kp_wid: int,
                    log_sparse: int) -> np.ndarray:
    return inp * gen_keep_vec_sparse(len(inp), in_wid, kp_wid, log_sparse)


def keep_vec_stride(inp: np.ndarray, in_wid: int, kp_wid: int, step: int,
                    ul: int, raw_in_wid_odd: bool) -> np.ndarray:
    return inp * gen_keep_vec_stride(len(inp), in_wid, kp_wid, step, ul,
                                     raw_in_wid_odd)


def apply_rot_maps(inp: np.ndarray, maps: dict[int, np.ndarray]) -> np.ndarray:
    """Σ_rot lrot(inp ⊙ mask, rot) — the plaintext twin of
    masked-rotate-accumulate (comprs_vec_sparse, rot_util.go:99-136)."""
    out = np.zeros_like(inp)
    for rot, mask in maps.items():
        out = out + lrot(inp * mask, rot)
    return out


def comprs_vec_sparse(inp: np.ndarray, in_wid: int, kp_wid: int,
                      log_sparse: int, ul: int, pos: int) -> np.ndarray:
    m_idx, r_idx = gen_comprs_sparse(len(inp), in_wid, kp_wid, log_sparse, ul, pos)
    return apply_rot_maps(apply_rot_maps(inp, m_idx), r_idx)


def comprs_full_fast(inp: np.ndarray, in_wid: int, kp_wid: int, pos: int,
                     ul: int) -> np.ndarray:
    m_idx, r_idx = gen_comprs_fast(len(inp), in_wid, kp_wid, pos, ul)
    return apply_rot_maps(apply_rot_maps(inp, m_idx), r_idx)


def comprs_full(inp: np.ndarray, in_wid: int, kp_wid: int, pos: int,
                ul: int) -> np.ndarray:
    r_idx = gen_comprs_full(len(inp), in_wid, kp_wid, pos, ul)
    return apply_rot_maps(inp, r_idx)


# Independent value-level ports (direct loop structure of the reference's
# comprs_full / comprs_full_fast, rot_util.go:277-422) — used by tests to
# cross-validate the generator-based path above.

def comprs_full_direct(inp: np.ndarray, in_wid: int, kp_wid: int, pos: int,
                       ul: int) -> np.ndarray:
    out = np.zeros_like(inp)
    batch = 2 * len(inp) // (in_wid * in_wid)
    pos = reverse_bits(pos, 2)
    mw = in_wid // 4
    log_iw = (in_wid - 1).bit_length()
    for j in range(2 * mw):
        tmp = np.zeros_like(inp)
        for b in range(batch):
            for i in range(mw):
                keep = reverse_bits(in_wid // 2 + j, log_iw) < kp_wid
                if ul == 1:
                    keep = keep and reverse_bits(3 * mw + i, log_iw - 1) \
                        < kp_wid - in_wid // 2
                if keep:
                    idx = 2 * mw * in_wid * b + 2 * mw * j + i + in_wid * mw + mw
                    tmp[idx] = inp[idx]
        rot = -j * mw + 2 * pos * mw * mw - mw - in_wid * mw
        out = out + np.roll(tmp, rot)
    return out


def comprs_full_fast_direct(inp: np.ndarray, in_wid: int, kp_wid: int, pos: int,
                            ul: int) -> np.ndarray:
    mid = np.zeros_like(inp)
    out = np.zeros_like(inp)
    batch = 2 * len(inp) // (in_wid * in_wid)
    pos = reverse_bits(pos, 2)
    mw = in_wid // 4
    log_iw = (in_wid - 1).bit_length()
    for j in range(2 * mw):
        tmp = np.zeros_like(inp)
        for b in range(batch):
            for i in range(mw):
                ok_j = reverse_bits(in_wid // 2 + j, log_iw) < kp_wid
                if ul == 0 and ok_j:
                    idx = 2 * mw * in_wid * b + 2 * mw * j + i + in_wid * mw + mw
                    tmp[idx] = inp[idx]
                if ul == 1 and ok_j and reverse_bits(mw + i, log_iw - 1) \
                        < kp_wid - in_wid // 2:
                    idx = 2 * mw * in_wid * b + 2 * mw * j + i + in_wid * mw + mw
                    tmp[idx] = inp[idx]
        rot = -j * mw + 2 * mw * mw - mw
        mid = mid + np.roll(tmp, rot)
    for b in range(batch):
        tmp = np.zeros_like(inp)
        for j in range(2 * mw):
            for i in range(mw):
                idx = 2 * mw * in_wid * b + 3 * in_wid // 2 * mw + j * mw + i
                tmp[idx] = mid[idx]
        rot = -3 * b * mw * in_wid // 2 + pos * mw * in_wid // 2 * batch \
            - 3 * mw * in_wid // 2
        out = out + np.roll(tmp, rot)
    return out
