"""Coefficient-domain multiplexed-packed convolution + BN.

Counterpart of ``optimal_conv_tpu/ops/conv.py``: the input layout
scatter (``prep_input``), kernel reshaping, BN fold and the negacyclic
alignment trick (``reshape_ker``, ``encode_ker_final``, ``prep_ker``),
the log-depth ciphertext packing butterfly (``pack_ctxts``) and the
fused ``conv_then_pack`` / ``eval_conv_bn`` drivers.

One homomorphic convolution over all channels is max_ob/norm NTT-domain
ct×pt products, a SetScale fold and rescale to level 0, and a log-depth
pack of monomial products and Galois automorphisms with level-0 key
switches.  ``_conv_pack`` runs that as plain tensor code with the
channels as a leading dim: each butterfly stage's key switches are one
batched call.  ``prep_ker`` makes those plaintexts on the device in one
batched pass, equal residue for residue to the host composition of
``reshape_ker`` and ``encode_ker_final`` (kept as its reference and its
fallback), and hands them to the pack as one tensor.

Spans (``utils/tracing.py``): ``conv_bn`` a call of ``eval_conv_bn`` (a
root when no span is open: a conv request), ``encode.kernel`` a
``prep_ker`` and ``pack`` a ``conv_then_pack``.  The counter
``conv.pack.keyswitches`` adds the key-switch rows each pack runs
(C - 1 for C plaintexts).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.context import CkksContext
from ..ckks.types import Ciphertext, Plaintext
from ..core import modmath as mm
from ..core import ntt as nttmod
from ..utils import tracing

# Conv inputs and kernel plaintexts live at level 1; one rescale brings
# the product to level 0, where the pack's key switches run.
ECD_LEVEL = 1


# ---------------------------------------------------------------------------
# host-side layout / kernel preparation (numpy)
# ---------------------------------------------------------------------------

def prep_input(raw: np.ndarray, raw_in_wid: int, in_wid: int, n: int,
               norm: int, trans: bool = False) -> np.ndarray:
    """Scatter a raw HWC vector into the N-coefficient layout:
    out[i·w·B + j·B + b·norm] = raw[(i, j, b)] for i, j < raw_in_wid
    (odd grid positions of a 2× grid when trans)."""
    out = np.zeros(n)
    batch = n // (in_wid * in_wid)
    nb = batch // norm
    raw = np.asarray(raw)
    if trans:
        i, j, b = np.meshgrid(np.arange(min(in_wid // 2, raw_in_wid)),
                              np.arange(min(in_wid // 2, raw_in_wid)),
                              np.arange(nb), indexing="ij")
        pos = (2 * i + 1) * in_wid * batch + (2 * j + 1) * batch + b * norm
    else:
        i, j, b = np.meshgrid(np.arange(min(in_wid, raw_in_wid)),
                              np.arange(min(in_wid, raw_in_wid)),
                              np.arange(nb), indexing="ij")
        pos = i * in_wid * batch + j * batch + b * norm
    out[pos.ravel()] = raw[: pos.size]
    return out


def post_process(cfs: np.ndarray, raw_in_wid: int, in_wid: int) -> np.ndarray:
    """Crop the valid raw_in_wid² region of a decoded N-vector."""
    batch = len(cfs) // (in_wid * in_wid)
    grid = np.asarray(cfs).reshape(in_wid, in_wid, batch)
    return grid[:raw_in_wid, :raw_in_wid].ravel().copy()


def reshape_ker(ker_in: np.ndarray, k_sz: int, out_batch: int,
                trans: bool) -> np.ndarray:
    """Flat python-order kernel → [out_b, in_b·k_sz]."""
    in_batch = len(ker_in) // (k_sz * out_batch)
    i = np.arange(out_batch)[:, None, None]
    j = np.arange(in_batch)[None, :, None]
    k = np.arange(k_sz)[None, None, :]
    out = np.zeros((out_batch, k_sz * in_batch))
    ker_in = np.asarray(ker_in)
    if trans:
        src = j + i * in_batch + k * out_batch * in_batch
        dst = j * k_sz + (k_sz - k - 1)
    else:
        src = i + j * out_batch + k * out_batch * in_batch
        dst = j * k_sz + k
    rows = np.broadcast_to(i, src.shape)
    out[rows, np.broadcast_to(dst, src.shape)] = ker_in[src]
    return out


def encode_ker_final(ker: np.ndarray, i: int, in_wid: int, in_batch: int,
                     ker_wid: int) -> np.ndarray:
    """Place kernel taps so the negacyclic product computes the
    correlation, with the result aligned to position 0."""
    vec_size = in_wid * in_wid * in_batch
    out = np.zeros(vec_size)
    k_sz = ker_wid * ker_wid
    j = np.arange(in_batch)[:, None]
    k = np.arange(k_sz)[None, :]
    dst = (in_wid * (k // ker_wid) + k % ker_wid) * in_batch + j
    out[dst] = ker[i][(in_batch - 1 - j) * k_sz + (k_sz - 1 - k)]
    # negacyclic left-shift by adj with sign-flip wraparound
    adj = (in_batch - 1) + in_batch * (in_wid + 1) * (ker_wid - 1) // 2
    if adj > 0:
        shifted = np.empty_like(out)
        shifted[: vec_size - 2 * adj] = out[adj: vec_size - adj]
        shifted[vec_size - 2 * adj: vec_size - adj] = out[vec_size - adj:]
        shifted[vec_size - adj:] = -out[:adj]
        out = shifted
    return out


# The batched kernel encoding works on chunks of output channels whose
# float64 / int64 temporaries stay under this many bytes.
_CHUNK_BYTES = 1 << 28


class KernelPlaintexts(list):
    """``prep_ker``'s list (a Plaintext at 0, norm, 2·norm, ..., None
    elsewhere) with ``polys``: the [C, l, N] tensor whose rows are those
    Plaintexts' ``poly``, so that ``conv_then_pack`` stacks nothing."""

    def __init__(self, items, polys: torch.Tensor):
        super().__init__(items)
        self.polys = polys


def _ker_layout(in_wid: int, ker_wid: int, max_bat: int, in_norm: int,
                real_ib: int, device: torch.device):
    """(pos, sign) [real_ib·k_sz] on `device`: where tap t of input
    channel b of every kernel plaintext lands, and its sign.  The
    composition of the overload placement (column in_norm·k_sz·b + t of
    ``max_ker``), ``encode_ker_final``'s placement of that column and its
    negacyclic left shift by adj, which negates what wraps around."""
    k_sz = ker_wid * ker_wid
    vec_size = in_wid * in_wid * max_bat
    adj = (max_bat - 1) + max_bat * (in_wid + 1) * (ker_wid - 1) // 2
    j = max_bat - 1 - in_norm * torch.arange(real_ib, device=device)[:, None]
    k = k_sz - 1 - torch.arange(k_sz, device=device)[None, :]
    pos = ((in_wid * (k // ker_wid) + k % ker_wid) * max_bat + j - adj).ravel()
    wrap = pos < 0
    return pos + vec_size * wrap, 1.0 - 2.0 * wrap.to(torch.float64)


@tracing.spanned("encode.kernel")
def prep_ker(ctx: CkksContext, ker_in: np.ndarray, bn_a: np.ndarray,
             in_wid: int, ker_wid: int, real_ib: int, real_ob: int,
             norm: int, trans: bool, in_norm: int | None = None) -> list:
    """Kernel reshape + BN fold + overload to max batch, then coeff-encode
    the kernel polys the pack reads (rows 0, norm, 2·norm, ...) as NTT +
    Montgomery plaintexts; other entries stay None.

    ``in_norm`` is the input channel stride where it differs from the
    output one (None: ``norm``).  The ImageNet FC-1000 head reads input
    channel c at 2c and writes its 1000 logits at stride 1
    (``optimal_conv_tpu/ops/conv.py:116-150``).

    The C = max_bat/norm plaintexts are made on the context's device in
    one pass from the weights uploaded once (``_ker_layout`` places
    them) into one [C, l, N] tensor, the returned ``KernelPlaintexts``'
    ``polys``; the residues equal ``_prep_ker_host``'s, the composition
    ``reshape_ker`` → BN fold → ``max_ker`` → ``encode_ker_final`` →
    ``encode_coeffs``, which takes weights whose scaled magnitude may
    reach 2^62 (the integers then exceed int64).  Counters
    ``encode.kernel.pts`` / ``encode.kernel.host_pts``: the plaintexts
    made each way."""
    p = ctx.params
    max_bat = p.n // (in_wid * in_wid)
    if in_norm is None:
        in_norm = norm
    k_sz = ker_wid * ker_wid
    ker = np.asarray(ker_in, dtype=np.float64).ravel()
    bn = np.broadcast_to(np.asarray(bn_a, dtype=np.float64), (real_ob,))
    in_batch = len(ker) // (k_sz * real_ob)
    if (real_ib > in_batch or norm * (real_ob - 1) >= max_bat
            or in_norm * (real_ib - 1) >= max_bat):
        raise ValueError(f"kernel of {real_ob} x {in_batch} channels does not "
                         f"fit {real_ib} inputs at stride {in_norm} and "
                         f"outputs at stride {norm} in a batch of {max_bat}")
    n_pts = len(range(0, max_bat, norm))
    top = max(ker.max(), -ker.min()) * np.abs(bn).max() if ker.size else 0.0
    if not top * p.scale < 2.0 ** 62:
        tracing.count("encode.kernel.pts", 0)
        tracing.count("encode.kernel.host_pts", n_pts)
        return _prep_ker_host(ctx, ker, bn, in_wid, ker_wid, real_ib, real_ob,
                              norm, trans, in_norm)
    tracing.count("encode.kernel.pts", n_pts)
    tracing.count("encode.kernel.host_pts", 0)
    enc = ctx.encoder
    dev = enc.tables.ntt.device
    ker = ker[: k_sz * real_ob * in_batch]
    if not ker.flags.writeable:
        ker = ker.copy()
    ker_d = torch.from_numpy(ker).to(dev)
    bn_d = torch.from_numpy(bn.copy()).to(dev)
    if dev.type != "cpu":
        tracing.count("encode.bytes_up", ker_d.nbytes + bn_d.nbytes)
    # w[r, b, t] = ker_rs[r, b·k_sz + t] of reshape_ker
    if trans:
        w = ker_d.view(k_sz, real_ob, in_batch).flip(0).permute(1, 2, 0)
    else:
        w = ker_d.view(k_sz, in_batch, real_ob).permute(2, 1, 0)
    w = w[:, :real_ib]
    pos, sign = _ker_layout(in_wid, ker_wid, max_bat, in_norm, real_ib, dev)
    idx = enc.rows(ECD_LEVEL, False)
    polys = torch.empty((n_pts, len(idx), p.n), dtype=torch.int64, device=dev)
    polys[real_ob:].zero_()
    nnz = real_ib * k_sz
    step = max(1, _CHUNK_BYTES // (8 * ((2 + len(idx)) * nnz
                                         + 2 * len(idx) * p.n)))
    for r0 in range(0, real_ob, step):
        r1 = min(r0 + step, real_ob)
        # NumPy's order: (ker·bn_a), the shift's sign, ·scale, round half
        # to even
        v = torch.empty((r1 - r0, real_ib, k_sz), dtype=torch.float64,
                        device=dev)
        torch.mul(w[r0:r1], bn_d[r0:r1, None, None], out=v)
        v = v.view(r1 - r0, nnz).mul_(sign).mul_(p.scale).round_()
        enc.encode_int_coeffs(v.to(torch.int64), pos, ECD_LEVEL,
                              polys[r0:r1])
    out = [None] * max_bat
    for r in range(n_pts):
        out[r * norm] = Plaintext(polys[r], level=ECD_LEVEL,
                                  scale=float(p.scale), is_mont=True)
    return KernelPlaintexts(out, polys)


def _prep_ker_host(ctx: CkksContext, ker_in: np.ndarray, bn_a: np.ndarray,
                   in_wid: int, ker_wid: int, real_ib: int, real_ob: int,
                   norm: int, trans: bool, in_norm: int) -> list:
    """``prep_ker`` one plaintext at a time on the host, for weights whose
    integers may not fit int64."""
    p = ctx.params
    max_bat = p.n // (in_wid * in_wid)
    k_sz = ker_wid * ker_wid
    ker_rs = reshape_ker(ker_in, k_sz, real_ob, trans)
    ker_rs = ker_rs * np.asarray(bn_a)[:, None]
    max_ker = np.zeros((max_bat, max_bat * k_sz))
    cols = (in_norm * k_sz * np.arange(real_ib)[:, None]
            + np.arange(k_sz)).ravel()
    max_ker[np.ix_(norm * np.arange(real_ob), cols)] = \
        ker_rs[:, : real_ib * k_sz]
    out = [None] * max_bat
    for i in range(0, max_bat, norm):
        coeffs = encode_ker_final(max_ker, i, in_wid, max_bat, ker_wid)
        out[i] = ctx.encoder.encode_coeffs(coeffs, p.scale, ECD_LEVEL)
    return out


# ---------------------------------------------------------------------------
# homomorphic packing + conv
# ---------------------------------------------------------------------------

def _pack_steps(log_n: int, max_cnum: int, norm: int):
    """(step, log_step, j) of each butterfly stage: stage pairs ciphertext
    i with i + step, multiplies by X^(2^log_step), rotates by 2^j + 1."""
    steps = []
    step = max_cnum // 2
    log_step = max(step.bit_length() - 1, 0)
    j = log_n - log_step
    while step >= norm and step >= 1:
        steps.append((step, log_step, j))
        step //= 2
        log_step -= 1
        j += 1
    return steps


def pack_ctxts(ctx: CkksContext, ctxts: list, max_cnum: int,
               real_cnum: int) -> Ciphertext:
    """Combine real_cnum sparse (stride-norm) ciphertexts into one via the
    log-depth (a − b·X^s, a + b·X^s, Galois 2^j+1) butterfly."""
    norm = max_cnum // real_cnum
    cts = list(ctxts)
    for i in range(0, max_cnum, norm):
        cts[i] = cts[i].with_scale(cts[i].scale * real_cnum)
    for step, log_step, j in _pack_steps(ctx.params.log_n, max_cnum, norm):
        for i in range(0, step, norm):
            tmp1 = ctx.mul_monomial(cts[i + step], 1 << log_step)
            tmp2 = ctx.sub(cts[i], tmp1)
            tmp1 = ctx.add(cts[i], tmp1)
            tmp2 = ctx.apply_galois(tmp2, (1 << j) + 1)
            cts[i] = ctx.add(tmp1, tmp2)
    return cts[0]


@tracing.spanned("pack")
def conv_then_pack(ctx: CkksContext, ct_in: Ciphertext, pl_ker: list,
                   max_ob: int, norm: int, out_scale: float,
                   bias_pt: Plaintext) -> Ciphertext:
    """One ct×pt product per (stride-norm) output-channel group, SetScale
    to out_scale/(max_ob/norm), pack, and add the BN bias."""
    if ct_in.level != ECD_LEVEL:
        raise ValueError(f"conv inputs live at the ECD level {ECD_LEVEL}")
    per_scale = out_scale / (max_ob // norm)
    pls = _kernel_polys(pl_ker, [pl_ker[i] for i in range(0, max_ob, norm)])
    if bias_pt.is_mont or bias_pt.level != 0:
        raise ValueError("the bias must be a level-0 standard-form plaintext")
    c0, c1 = _conv_pack(ctx, ct_in.c0, ct_in.c1, pls, max_ob, norm,
                        ct_in.scale * pl_ker[0].scale, per_scale,
                        bias_pt.poly)
    out = Ciphertext(c0, c1, level=0, scale=per_scale * (max_ob // norm))
    assert abs(out.scale / out_scale - 1) < 1e-9, (out.scale, out_scale)
    return out


def _kernel_polys(pl_ker: list, pts: list) -> torch.Tensor:
    """[C, l, N]: the polys of `pts`, ``pl_ker``'s own ``polys`` when
    they are still its rows in order (``prep_ker``'s result), else a
    stacked copy."""
    polys = getattr(pl_ker, "polys", None)
    if polys is not None and polys.shape[0] == len(pts):
        base, step = polys.data_ptr(), polys.stride(0) * polys.element_size()
        if all(pt.poly.data_ptr() == base + r * step
               for r, pt in enumerate(pts)):
            return polys
    return torch.stack([pt.poly for pt in pts])


def _conv_pack(ctx: CkksContext, c0: torch.Tensor, c1: torch.Tensor,
               pls: torch.Tensor, max_ob: int, norm: int, scale_prod: float,
               per_scale: float, bias: torch.Tensor):
    """The fused conv-pack of the JAX package (``_conv_pack_kernel``) as
    tensor code.  c0, c1: [2, N] at level 1; pls: [C, 2, N] NTT +
    Montgomery, C = max_ob // norm.  Returns the level-0 pair.  On a
    sharded context the rows are the rank's limbs of levels 1 and 0 (a
    rank may hold neither; it still joins every collective)."""
    p = ctx.params
    ntt = ctx.ntt
    q1 = p.q_moduli[1]
    # SetScale fold: multiply by c = round(target·q1/scale), rescale by q1
    c_int = int(round(per_scale * q1 / scale_prod))
    if c_int < 1:
        raise ValueError(f"SetScale constant {c_int} < 1")
    q01, qinv01, r2_01, _ = ntt.tabs(ctx.q_rows(1))
    q0, qinv0 = ntt.tabs(ctx.q_rows(0))[:2]
    c_mont = mm.to_mont(ctx._const_col(c_int, 1), q01, qinv01, r2_01)
    steps = _pack_steps(p.log_n, max_ob, norm)
    # the pack's key-switch rows: sum of k over the stages, C - 1
    tracing.count("conv.pack.keyswitches", sum(s // norm for s, _, _ in steps))
    m0 = mm.mont_mul2(c0[None], pls, c_mont, q01, qinv01)
    m1 = mm.mont_mul2(c1[None], pls, c_mont, q01, qinv01)
    cur0, cur1 = ctx._rescale_pair(m0, m1, 1)     # [C, 1, N]
    for stp, ls, jj in steps:
        mono = ctx.monomial_pt(1 << ls, 0)
        g = (1 << jj) + 1
        perm = ctx.galois_perm(g)
        swk = ctx.galois_key(g, 0)
        k = stp // norm
        a0, a1 = cur0[:k], cur1[:k]
        b0 = mm.mont_mul(cur0[k: 2 * k], mono, q0, qinv0)
        b1 = mm.mont_mul(cur1[k: 2 * k], mono, q0, qinv0)
        t10 = mm.add_mod(a0, b0, q0)
        t11 = mm.add_mod(a1, b1, q0)
        t20 = nttmod.apply_galois_ntt(mm.sub_mod(a0, b0, q0), perm)
        t21 = nttmod.apply_galois_ntt(mm.sub_mod(a1, b1, q0), perm)
        ks0, ks1 = ctx.keyswitch(t21, 0, swk)     # all k key switches at once
        cur0 = mm.add_mod(t10, mm.add_mod(t20, ks0, q0), q0)
        cur1 = mm.add_mod(t11, ks1, q0)
    return mm.add_mod(cur0[0], bias, q0), cur1[0]


@tracing.spanned("conv_bn")
def eval_conv_bn(ctx: CkksContext, ct_in: Ciphertext, ker_in: np.ndarray,
                 bn_a: np.ndarray, bn_b: np.ndarray, in_wid: int, ker_wid: int,
                 real_ib: int, real_ob: int, norm: int, out_scale: float,
                 trans: bool = False,
                 in_norm: int | None = None) -> Ciphertext:
    """Conv + BN: kernel prep, conv_then_pack, coeff-encoded bias.
    ``in_norm``: the input channel stride (``prep_ker``); the bias stays
    at the output stride ``norm``."""
    p = ctx.params
    max_batch = p.n // (in_wid * in_wid)
    pl = prep_ker(ctx, ker_in, bn_a, in_wid, ker_wid, real_ib, real_ob, norm,
                  trans, in_norm)
    b_coeffs = np.zeros(p.n)
    for i, b in enumerate(np.asarray(bn_b)):
        b_coeffs[norm * i::max_batch] = b
    pl_b = ctx.encoder.encode_coeffs(b_coeffs, out_scale, 0, mont=False)
    return conv_then_pack(ctx, ct_in, pl, max_batch, norm, out_scale,
                          bias_pt=pl_b)


# ---------------------------------------------------------------------------
# plaintext reference
# ---------------------------------------------------------------------------

def conv2d_same_np(img: np.ndarray, ker: np.ndarray) -> np.ndarray:
    """img [H, W, Cin], ker [kh, kw, Cin, Cout] → [H, W, Cout]
    (cross-correlation with zero 'same' padding)."""
    h, w, cin = img.shape
    kh, kw, _, cout = ker.shape
    out = np.zeros((h, w, cout))
    ph, pw = kh // 2, kw // 2
    pad = np.zeros((h + 2 * ph, w + 2 * pw, cin))
    pad[ph: ph + h, pw: pw + w] = img
    for di in range(kh):
        for dj in range(kw):
            out += np.einsum("hwc,co->hwo", pad[di: di + h, dj: dj + w],
                             ker[di, dj])
    return out
