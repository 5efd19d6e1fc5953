"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip without one.
They import only torch and the port, so they also run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Residue-level results must be equal: each kernel computes the same
exact modular arithmetic as its plain version.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.context import CkksContext, SwitchingKey
from optimal_conv_tpu_torch.ckks.params import boot_params, mini_boot_params
from optimal_conv_tpu_torch.core import modmath as mm
from optimal_conv_tpu_torch.core import d1_kernel, mod_add_kernel, mont_kernel
from optimal_conv_tpu_torch.core import ntt_kernel
from optimal_conv_tpu_torch.core import mxu_kernel, mxu_ntt, rns, rns_kernel
from optimal_conv_tpu_torch.core import threefry
from optimal_conv_tpu_torch.core.ntt import (NttContext, _ntt_fwd, _ntt_inv,
                                             galois_perm_ntt, rot_to_galois)
from optimal_conv_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _residues(mods, shape, rng, dev):
    """Uniform residues [..., L, N] including 0 and q-1 in every row."""
    out = np.stack([rng.integers(0, q, size=shape[:-2] + shape[-1:],
                                 dtype=np.int64) for q in mods], axis=-2)
    out[..., 0] = 0
    out[..., 1] = np.array(mods, dtype=np.int64) - 1
    return torch.from_numpy(out).to(dev)


def _mont_case(case, dev):
    """Operands (a, b, q, qinv) of one call pattern of the Montgomery
    product, and whether the plan should take 16-byte accesses."""
    rng = np.random.default_rng(1)
    mods = boot_params(12).moduli[:6]
    n = 4096
    q, qinv, r2, _ = mm.limb_tables(mods, dev)
    a = _residues(mods, (6, n), rng, dev)
    b = _residues(mods, (6, n), rng, dev)
    if case == "same":
        return (a, b, q, qinv), True
    if case == "row_scalar":             # a Montgomery constant per row
        return (a, r2, q, qinv), True
    if case == "scalar_a":               # the same, as the first operand
        return (r2, b, q, qinv), True
    if case == "lead_bcast":             # one ciphertext × C plaintexts
        bb = _residues(mods, (3, 6, n), rng, dev)
        return (a[None], bb, q, qinv), True
    if case == "mid_bcast":              # basis extension: y[..., None, :, :]
        a2 = torch.stack([a, a.flip(-1)])[:, None]            # [2, 1, 6, n]
        bs = torch.stack([b[:, :1] % q[i] for i in range(3)])  # [3, 6, 1]
        return (a2, bs, q[:3, None], qinv[:3, None]), True    # → [2, 3, 6, n]
    if case == "rns_extend":             # y[..., j:j+1, :] × [R, 1] → [B, R, n]
        y = _residues(mods[:4], (5, 4, n), rng, dev)
        return (y[..., 1:2, :], r2[:3], q[:3], qinv[:3]), True
    if case == "sliced":                 # non-contiguous row slices
        return (a[1::2], b[:3], q[1::2], qinv[1::2]), True
    if case == "scalar_view":            # offset by one element: 8-byte accesses
        wide = _residues(mods, (6, n + 2), rng, dev)
        return (wide[:, 1:n + 1], b, q, qinv), False
    if case == "n2":
        return (a[:, :2].contiguous(), b[:, :2].contiguous(), q, qinv), True
    if case == "odd_n":                  # a ragged tile on the scalar path
        return (a[:, :1031].contiguous(), b[:, :1031].contiguous(), q, qinv), False
    if case == "long_rows":              # [6, 2^16]: many tiles a row
        return (_residues(mods, (6, 1 << 16), rng, dev),
                _residues(mods, (6, 1 << 16), rng, dev), q, qinv), True
    if case == "streamed":               # more bytes than the L2 holds
        ct = _residues(mods[:2], (1, 2, 1 << 16), rng, dev)
        pls = _residues(mods[:2], (40, 2, 1 << 16), rng, dev)
        return (ct, pls, q[:2], qinv[:2]), True
    if case == "many_rows":              # more rows than one grid dim holds
        rows = _residues(mods[:1], (70000, 1, 4), rng, dev)
        return (rows, r2[:1], q[:1], qinv[:1]), True
    assert case == "many_dims"           # more unmergeable row dims than four
    a7 = _residues(mods[:2], (2, 1, 2, 1, 2, 1, 2, 64), rng, dev)
    b7 = _residues(mods[:2], (1, 2, 1, 2, 1, 2, 2, 64), rng, dev)
    return (a7, b7, q[:2], qinv[:2]), True


MONT_CASES = ["same", "row_scalar", "lead_bcast", "mid_bcast", "sliced",
              "scalar_a", "rns_extend", "scalar_view", "n2", "odd_n",
              "long_rows", "streamed", "many_rows", "many_dims"]


@pytest.mark.parametrize("case", MONT_CASES)
def test_mont_mul_kernel_equals_plain(dev, case):
    args, vec = _mont_case(case, dev)
    if case != "many_dims":
        pl = mont_kernel.plan(*mont_kernel.describe(*args))
        assert pl.vec == vec
        assert pl.threads == mont_kernel.THREADS
    mont_kernel.STATS.reset()
    got = mm.mont_mul(*args)
    assert mont_kernel.STATS.launches == 1
    want = mm.mont_mul_plain(*args)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["lead_bcast", "scalar_view", "odd_n",
                                  "streamed", "many_dims"])
def test_mont_mul2_kernel_equals_plain(dev, case):
    """The chained product is one launch and equals two plain products."""
    (a, b, q, qinv), _ = _mont_case(case, dev)
    rng = np.random.default_rng(2)
    c = torch.from_numpy(np.array(
        [[int(rng.integers(0, int(m)))] for m in q[:, 0].tolist()])).to(dev)
    c[0, 0] = q[0, 0] - 1
    mont_kernel.STATS.reset()
    got = mm.mont_mul2(a, b, c, q, qinv)
    assert mont_kernel.STATS.launches == 1
    assert mont_kernel.STATS.plain_calls == 0
    assert torch.equal(got, mm.mont_mul2_plain(a, b, c, q, qinv))


def _mod_add_case(case, dev):
    """One call pattern of the additive kernel at the main path's widths:
    (the ``modmath`` function, its plain version), the arguments, and
    whether the plan should take 16-byte accesses (None: no plan to
    check)."""
    rng = np.random.default_rng(3)
    p = boot_params(16)
    n = p.n
    qs = p.q_moduli
    m29, m33 = p.moduli[:29], p.moduli[:33]
    q29 = mm.limb_tables(m29, dev)[0]
    q33 = mm.limb_tables(m33, dev)[0]
    q1 = q29[:1]

    def col(q):                          # a [L, 1] column of residues
        return torch.tensor([[int(rng.integers(0, m))] for m in
                             q[:, 0].tolist()], dtype=torch.int64, device=dev)

    def top(shape, qt):                  # a top limb's coefficients
        t = torch.from_numpy(rng.integers(0, qt, size=shape, dtype=np.int64))
        t.view(-1)[:3] = torch.tensor([qt // 2, qt // 2 + 1, qt - 1])
        return t.to(dev)

    add = (mm.add_mod, mm.add_mod_plain)
    sub = (mm.sub_mod, mm.sub_mod_plain)
    neg = (mm.neg_mod, mm.neg_mod_plain)
    summ = (mm.sum_mod, mm.sum_mod_plain)
    centred = (mm.centred_sub, mm.centred_sub_plain)
    a = _residues(m29, (29, n), rng, dev)
    b = _residues(m29, (29, n), rng, dev)
    if case == "add_29":                 # two [29, N] polynomials
        return add, (a, b, q29), True
    if case == "add_col":                # add_const's cached column
        return add, (a, col(q29), q29), True
    if case == "sub_col":                # ModRaise: e − q0 mod q_i
        return sub, (a, col(q29), q29), True
    if case == "sub_digit_views":        # _ks_core's t0[..., d, :, :]
        t0 = _residues(m33, (2, 3, 33, n), rng, dev)
        return sub, (t0[:, 0], t0[:, 2], q33), True
    if case == "neg_29":
        return neg, (a, q29), True
    if case == "add_pack":               # the conv pack: [C, 1, N] on limb 0
        return add, (_residues(m29[:1], (16, 1, n), rng, dev),
                     _residues(m29[:1], (16, 1, n), rng, dev), q1), True
    if case == "sum_babies":             # one giant's inner sum on Q·P
        return summ, (_residues(m33, (8, 33, n), rng, dev), q33, 0), True
    if case == "sum_16":                 # a 16-term stack
        t = _residues(m29[:4], (16, 4, n), rng, dev)
        t[..., 2] = (q29[:4] - 1).T      # every addition wraps
        return summ, (t, q29[:4], 0), True
    if case == "sum_digits":             # _ks_core's digit sum, a lead dim
        return summ, (_residues(m33[:21], (2, 4, 21, n), rng, dev), q33[:21],
                      -3), True
    if case == "centred_rescale":        # the rescale's top limb, 27 limbs
        qt = int(qs[27])
        return centred, (a[:27], top((1, n), qt), qt // 2, col(q29[:27]),
                         q29[:27]), True
    if case == "centred_batch":          # C ciphertexts [C, 1, N], their tops
        qt = int(qs[1])
        return centred, (_residues(m29[:1], (16, 1, n), rng, dev),
                         top((16, 1, n), qt), qt // 2, col(q1), q1), True
    if case == "scalar_view":            # offset by one element: 8-byte path
        wide = _residues(m29[:6], (6, 4098), rng, dev)
        return sub, (wide[:, 1:4097], wide[:, :4096].contiguous(), q29[:6]), \
            False
    if case == "odd_n":
        return add, (a[:6, :1031].contiguous(), b[:6, :1031].contiguous(),
                     q29[:6]), False
    if case == "odd_step_sum":           # terms 4097 elements apart
        flat = _residues(m29[:1], (1, 5 * 4097), rng, dev).reshape(-1)
        t = flat.as_strided((5, 1, 4096), (4097, 4096, 1))
        return summ, (t, q1, 0), False
    if case == "empty":
        return add, (a[:, :0], b[:, :0], q29), None
    if case == "many_rows":              # more rows than one grid dim holds
        return neg, (_residues(m29[:1], (70000, 1, 4), rng, dev), q1), True
    assert case == "many_dims"           # more unmergeable row dims than four
    a7 = _residues(m29[:2], (2, 1, 2, 1, 2, 1, 2, 64), rng, dev)
    b7 = _residues(m29[:2], (1, 2, 1, 2, 1, 2, 2, 64), rng, dev)
    return add, (a7, b7, q29[:2]), None


MOD_ADD_CASES = ["add_29", "add_col", "sub_col", "sub_digit_views", "neg_29",
                 "add_pack", "sum_babies", "sum_16", "sum_digits",
                 "centred_rescale", "centred_batch", "scalar_view", "odd_n",
                 "odd_step_sum", "empty", "many_rows", "many_dims"]


def _mod_add_plan(fn, args):
    """The plan the wrapper takes for one call of a ``modmath`` form."""
    ak = mod_add_kernel
    if fn is mm.sum_mod:
        t, q, dim = args
        dim %= t.dim()
        key = ak.describe(ak.SUM, (t.select(dim, 0), q), t.shape[dim],
                          t.stride(dim))
    elif fn is mm.centred_sub:
        a, b, half, c, q = args
        key = ak.describe(ak.CENTRED, (a, b, q, c), half=half)
    else:
        op = {mm.add_mod: ak.ADD, mm.sub_mod: ak.SUB, mm.neg_mod: ak.NEG}[fn]
        key = ak.describe(op, args)
    return ak.plan(*key)


@pytest.mark.parametrize("case", MOD_ADD_CASES)
def test_mod_add_kernel_equals_plain(dev, case):
    """Each form of the additive kernel is one launch (none for an empty
    output) and equals its plain version bit for bit, on the card and on
    the CPU."""
    (fn, plain), args, vec = _mod_add_case(case, dev)
    if vec is not None:
        pl = _mod_add_plan(fn, args)
        assert pl.vec == vec and pl.threads == mod_add_kernel.THREADS
    mod_add_kernel.STATS.reset()
    got = fn(*args)
    assert mod_add_kernel.STATS.launches == (0 if case == "empty" else 1)
    assert mod_add_kernel.STATS.plain_calls == 0
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == torch.int64
    assert torch.equal(got, want)
    cpu = [t.cpu() if torch.is_tensor(t) else t for t in args]
    assert torch.equal(got.cpu(), plain(*cpu))


def test_mod_add_kernel_rejects_bad_input(dev):
    mods = boot_params(10).moduli[:2]
    q = mm.limb_tables(mods, dev)[0]
    a = torch.zeros(2, 1024, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):                     # not int64
        mm.add_mod(a.int(), a, q)
    with pytest.raises(TypeError):                     # mixed devices
        mm.sub_mod(a, a.cpu(), q)
    with pytest.raises(TypeError):
        mm.centred_sub(a, a[:1], 1, q.cpu(), q)
    with pytest.raises(TypeError):
        mm.sum_mod(torch.stack([a, a]), q.int())
    with pytest.raises(ValueError):                    # q varies along a row
        mm.neg_mod(a, a)
    with pytest.raises(ValueError):                    # the last axis
        mod_add_kernel.sum_mod_cuda(a, q, -1)


def test_span_holds_its_kernel_on_the_profilers_clock(dev):
    """Under torch.profiler with the CUDA activity alone the recorder is
    on, and the device interval of a K1 launch lies inside the span that
    holds the launch and a synchronise, both on ``time.time_ns``: the
    program's spans share the device trace's clock."""
    from torch.profiler import ProfilerActivity, profile
    (a, b, q, qinv), _ = _mont_case("same", dev)
    mont_kernel.mont_mul_cuda(a, b, q, qinv)      # the build and the plan
    torch.cuda.synchronize(dev)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert tracing.recording()
        with tracing.span("k1"):
            mont_kernel.mont_mul_cuda(a, b, q, qinv)
            torch.cuda.synchronize(dev)
    assert not tracing.recording()
    rec = [r for r in tracing.records() if r["name"] == "k1"][-1]
    tracing.clear()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [(ev.start_ns(), ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == cuda and "mont_mul" in ev.name()]
    assert len(evs) == 1
    start, dur = evs[0]
    assert rec["t0"] <= start and start + dur <= rec["t1"]
    calls, ns, rows = rec["kernels"]["mont_mul"]
    assert calls == 1 and rows == 6 and 0 < ns < rec["t1"] - rec["t0"]


@pytest.fixture(scope="module")
def tables16(dev):
    """The fork's logN-16 chain's NTT tables on the card."""
    p = boot_params(16)
    return p, NttContext(p.moduli, p.log_n, dev)


@pytest.mark.parametrize("permuted", [False, True], ids=["plain_key", "galh"])
@pytest.mark.parametrize("level", [27, 0])
def test_d1_regen_kernel_equals_plain(dev, tables16, level, permuted):
    """A key's uniform half at [6,33,N] (level 27) and [1,6,N] (level 0),
    unpermuted and permuted by φ_g⁻¹: one launch, equal to the plain
    draw residue for residue (max_abs_err 0), on a seed above 2^32."""
    p, ntt = tables16
    qp = p.qp_idx(level)
    beta = len(p.digits(level))
    assert (beta, len(qp)) == ((6, 33) if level else (1, 6))
    perm = None
    if permuted:
        g_inv = pow(rot_to_galois(3, p.log_n), -1, 2 * p.n)
        perm = torch.from_numpy(galois_perm_ntt(p.log_n, g_inv).copy()).to(dev)
    tabs = ntt.tabs(qp)
    d1_kernel.STATS.reset()
    got = threefry.uniform_mont((1 << 40) + level, beta, *tabs, p.n, perm)
    assert (d1_kernel.STATS.launches, d1_kernel.STATS.plain_calls) == (1, 0)
    want = threefry.uniform_mont_plain((1 << 40) + level, beta, *tabs, p.n,
                                       perm)
    assert got.shape == (beta, len(qp), p.n)
    assert torch.equal(got, want)
    q = tabs[0].reshape(1, -1, 1)
    assert bool((got >= 0).all()) and bool((got < q).all())


@pytest.mark.parametrize("permuted", [False, True], ids=["plain_key", "galh"])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_d1_regen_kernel_row_subset(dev, tables16, rank, permuted):
    """A tp-4 rank's rows of the level-27 key ([6,33,N]; LimbPlacement),
    drawn alone at their counters in the key: one launch, equal to the
    plain version's rows and to the whole draw's rows."""
    from optimal_conv_tpu_torch.parallel.limbs import LimbPlacement

    p, ntt = tables16
    level = 27
    qp = p.qp_idx(level)
    beta = len(p.digits(level))
    pl = LimbPlacement(p, 4)
    mine = pl.q_rows(level, rank) + pl.p_rows(rank)
    rows = tuple(qp.index(i) for i in mine)
    perm = None
    if permuted:
        g_inv = pow(rot_to_galois(3, p.log_n), -1, 2 * p.n)
        perm = torch.from_numpy(galois_perm_ntt(p.log_n, g_inv).copy()).to(dev)
    seed = (1 << 40) + rank
    whole = threefry.uniform_mont(seed, beta, *ntt.tabs(qp), p.n, perm)
    d1_kernel.STATS.reset()
    got = threefry.uniform_mont(seed, beta, *ntt.tabs(mine), p.n, perm,
                                rows=rows, nqp=len(qp))
    assert (d1_kernel.STATS.launches, d1_kernel.STATS.plain_calls) == (1, 0)
    assert got.shape == (beta, len(mine), p.n)
    assert torch.equal(got, whole[:, list(rows)])
    assert torch.equal(got, threefry.uniform_mont_plain(
        seed, beta, *ntt.tabs(mine), p.n, perm, rows=rows, nqp=len(qp)))


def test_d1_regen_kernel_rejects_bad_input(dev, tables16):
    p, ntt = tables16
    tabs = ntt.tabs(p.qp_idx(0))
    with pytest.raises(TypeError):
        d1_kernel.d1_regen_cuda(1, 1, *tabs, p.n,
                                torch.arange(p.n, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        d1_kernel.d1_regen_cuda(1, 1, tabs[0], tabs[1].cpu(), *tabs[2:], p.n)
    with pytest.raises(ValueError):
        d1_kernel.d1_regen_cuda(1, 1, *[t.cpu() for t in tabs], p.n)


def test_compressed_keys_on_card_equal_whole_keys(dev):
    """On the card, a context with seed-compressed keys (d1 regenerated by
    the kernel) and one with every key stored whole: the same keys, and
    rotations, hoisted rotations and ct × ct products equal residue for
    residue; the whole key's d1 equals the CPU context's (the draw does
    not depend on the device)."""
    p = boot_params(12)
    whole = CkksContext(p, dev, seed=9, compress_keys=False)
    comp = CkksContext(p, dev, seed=9, compress_keys=True)
    cpu = CkksContext(p, "cpu", seed=9, compress_keys=False)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, p.slots)
    ct = whole.encrypt(whole.encoder.encode_slots(x, p.scale, 15))
    d1_kernel.STATS.reset()
    for k in (1, 5):
        got, want = comp.rotate(ct, k), whole.rotate(ct, k)
        assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    rots = [1, 2, 3]
    got, want = comp.rotate_hoisted(ct, rots), whole.rotate_hoisted(ct, rots)
    for k in rots:
        assert torch.equal(got[k].c0, want[k].c0)
        assert torch.equal(got[k].c1, want[k].c1)
    a, b = comp.mul_ct(ct, ct), whole.mul_ct(ct, ct)
    assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
    assert d1_kernel.STATS.launches > 0 and d1_kernel.STATS.plain_calls == 0
    for tag, k in comp.switching_keys.items():
        assert k.d1 is None
        assert torch.equal(k.d0, whole.switching_keys[tag].d0)
        assert torch.equal(comp.swk_d1(k), whole.switching_keys[tag].d1)
    rk = whole.rot_key(5, 15)
    assert torch.equal(rk.d1.cpu(), cpu.rot_key(5, 15).d1)


@pytest.mark.parametrize("log_n", [3, 8, 9, 10, 11, 12, 13, 14, 15, 16])
def test_ntt_kernel_equals_plain(dev, log_n):
    """Every branch of the plan: one launch up to 2^14, two above; the
    short first round (k mod 3 = 1, 2) and none.  The logN-16 chain's
    primes are 1 mod 2^17, so they carry every smaller ring."""
    mods = boot_params(16).moduli
    ctx = NttContext(mods, log_n, dev)
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    idx = tuple(range(len(mods)))
    a = _residues(mods, (len(idx), n), rng, dev)
    q, qinv = ctx.tabs(idx)[:2]
    psi, ipsi, ninv = ctx.plain_tabs(idx)
    ntt_kernel.STATS_FWD.reset()
    f = ctx.ntt(a, idx)
    assert ntt_kernel.STATS_FWD.launches == 1
    assert torch.equal(f, _ntt_fwd(a, psi, q, qinv, log_n))
    back = ctx.intt(f, idx)
    assert torch.equal(back, _ntt_inv(f, ipsi, ninv, q, qinv, log_n))
    assert torch.equal(back, a)
    # limb subsets and [beta, l, N] batches, as key switching calls them
    for sub in ((3, 1), (0,), (1,)):
        x = a[list(sub)]
        qs, qis = ctx.tabs(sub)[:2]
        ps = ctx.plain_tabs(sub)[0]
        assert torch.equal(ctx.ntt(x, sub), _ntt_fwd(x, ps, qs, qis, log_n))
    sub = (0, 1, 2, 28, 29, 30)
    xb = torch.stack([a[list(sub)], a[list(sub)].flip(-1)])
    qs, qis = ctx.tabs(sub)[:2]
    ps = ctx.plain_tabs(sub)[0]
    assert torch.equal(ctx.ntt(xb, sub), _ntt_fwd(xb, ps, qs, qis, log_n))


@pytest.mark.parametrize("log_n", [12, 16])
@pytest.mark.parametrize("view", ["p_rows", "batch_step"])
def test_ntt_kernel_strided_input(dev, log_n, view):
    """A slice of the limb dim is read in place through its strides (the
    P rows of a QP accumulator, as mod-down passes them); a view whose
    batch dims do not collapse is copied once.  Both equal the plain
    version on the same view and leave the input as it was."""
    mods = boot_params(16).moduli
    ctx = NttContext(mods, log_n, dev)
    rng = np.random.default_rng(7)
    n = 1 << log_n
    qp = (0, 1, 2, 3, 4, 32)
    acc = _residues([mods[i] for i in qp], (4, 6, n), rng, dev)
    if view == "p_rows":
        x, sub = acc[:2, 5:, :], qp[5:]
        assert ntt_kernel._row_strides(x) == (6 * n, n)
    else:
        x, sub = acc.reshape(2, 2, 6, n).transpose(0, 1)[:, :, 2:, :], qp[2:]
        assert ntt_kernel._row_strides(x) is None
    assert not x.is_contiguous()
    keep = acc.clone()
    q, qinv = ctx.tabs(sub)[:2]
    psi, ipsi, ninv = ctx.plain_tabs(sub)
    f = ctx.ntt(x, sub)
    assert f.is_contiguous() and f.shape == x.shape
    assert torch.equal(f, _ntt_fwd(x, psi, q, qinv, log_n))
    assert torch.equal(ctx.intt(x, sub), _ntt_inv(x, ipsi, ninv, q, qinv, log_n))
    assert torch.equal(acc, keep)


@pytest.fixture(scope="module")
def ntt16(dev):
    p = boot_params(16)
    return p, NttContext(p.moduli, p.log_n, dev)


def _shard_rows(p, lead):
    """(limbs, batch) of the cross-stage shapes: the 28 limbs of level 27,
    or its six key-switch digits of 33 rows."""
    return (p.q_idx(27), 1) if lead == "q27" else (p.qp_idx(27), 6)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("sp,lead", [(2, "q27"), (4, "digits27")])
def test_ntt_cross_kernel_equals_plain(dev, ntt16, sp, lead, upper, inverse):
    """The cross stage at [28, N/2] and [6, 33, N/4] equals its plain
    version, one launch, for both halves of both directions."""
    from optimal_conv_tpu_torch.core.ntt import ntt_cross_plain
    from optimal_conv_tpu_torch.parallel.coeffs import cross_stages
    p, ntt = ntt16
    idx, batch = _shard_rows(p, lead)
    rng = np.random.default_rng(sp + 2 * upper + 4 * inverse)
    shape = (batch, len(idx), p.n // sp)
    mine, theirs = (_residues([p.moduli[i] for i in idx], shape, rng, dev)
                    for _ in range(2))
    col = cross_stages(sp, sp - 1, inverse)[-1][2]
    w = (ntt.ipsi_br if inverse else ntt.psi_br)[:, col].contiguous()
    ntt_kernel.STATS_CROSS.reset()
    got = ntt_kernel.ntt_cross_cuda(mine, theirs, ntt._row_limb(idx, batch),
                                    ntt.q_vec, ntt.qinv_vec, w, upper, inverse)
    assert ntt_kernel.STATS_CROSS.launches == 1
    q, qinv = ntt.tabs(idx)[:2]
    want = ntt_cross_plain(mine, theirs, w[list(idx)][:, None], q, qinv, upper,
                           inverse)
    assert torch.equal(got, want)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ntt_kernel_on_shard_tables(dev, ntt16, sp, inverse):
    """K2/K3 at log_n - log2(sp) on a shard's twiddle table (the inverse
    with the whole ring's n^-1) equal the plain local sub-transform."""
    from optimal_conv_tpu_torch.parallel.coeffs import shard_twiddles
    p, ntt = ntt16
    idx = p.qp_idx(27)
    log_cols = p.log_n - (sp.bit_length() - 1)
    rng = np.random.default_rng(sp)
    x = _residues([p.moduli[i] for i in idx], (6, len(idx), p.n // sp), rng,
                  dev)
    s = sp - 1
    tab = shard_twiddles(ntt.ipsi_br if inverse else ntt.psi_br, sp, s)
    got = ntt_kernel.ntt_cuda(x, ntt._row_limb(idx, 6), ntt.q_vec, ntt.qinv_vec,
                              tab, ntt.n_inv, log_cols, inverse)
    q, qinv = ntt.tabs(idx)[:2]
    sel = torch.tensor(idx, device=dev)
    rows = tab.index_select(0, sel)
    want = (_ntt_inv(x, rows, ntt.n_inv.index_select(0, sel)[:, None], q, qinv,
                     log_cols) if inverse
            else _ntt_fwd(x, rows, q, qinv, log_cols))
    assert torch.equal(got, want)


def test_sharded_step_dryrun_on_card(dev):
    """The limb-sharded layer step at one rank on the card (no process
    group: its collectives are the identity) equals the single-device
    rescale(rotate(mul_plain)) residue for residue, through the kernels."""
    from optimal_conv_tpu_torch.parallel import sharding
    for s in (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV):
        s.reset()
    assert sharding.dryrun(1, log_n=12, device=dev) == {}
    for s in (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV):
        assert s.launches > 0 and s.plain_calls == 0


@pytest.mark.parametrize("log_n", [10, 12, 16])
def test_mxu_kernel_equals_plain_and_butterfly(dev, log_n):
    """The matrix NTT's kernel on mixed-width rows (the fork's 4-, 6-, 7- and
    8-byte limbs in one call, a batch of two; B = 4, 16 and 256, so padded
    and whole tiles), forward and inverse, against its plain version on the
    card and against K2/K3; the round trip; the wrapper called alone; a
    strided view read in place and left as it was."""
    mods = boot_params(16).moduli
    ctx = NttContext(mods, log_n, dev, backend="mxu")
    bfly = NttContext(mods, log_n, dev)
    tabs = ctx.mxu_tables()
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    idx = (5, 4, 0, 2, 28)
    acc = _residues([mods[i] for i in (1,) + idx], (2, 6, n), rng, dev)
    x = acc[:, 1:, :]
    keep = acc.clone()
    assert [tabs.nbytes[i] for i in idx] == [4, 6, 7, 8, 8]
    for s in (mxu_kernel.STATS_FWD, mxu_kernel.STATS_INV):
        s.reset()
    f = ctx.ntt(x, idx)
    back = ctx.intt(f, idx)
    assert (mxu_kernel.STATS_FWD.launches, mxu_kernel.STATS_INV.launches) == (1, 1)
    assert torch.equal(f, mxu_ntt.mxu_fwd_plain(x, idx, tabs))
    assert torch.equal(f, bfly.ntt(x, idx))
    assert torch.equal(back, mxu_ntt.mxu_inv_plain(f, idx, tabs))
    assert torch.equal(back, bfly.intt(f, idx))
    assert torch.equal(back, x) and torch.equal(acc, keep)
    for inverse, src, want in ((False, x, f), (True, f, back)):
        assert torch.equal(mxu_kernel.mxu_cuda(src, idx, tabs, inverse), want)
    assert (mxu_kernel.STATS_FWD.plain_calls, mxu_kernel.STATS_INV.plain_calls
            ) == (1, 1)


def test_mxu_route_on_unindexed_cuda_device(dev):
    """A context built on "cuda" (no index) takes the matrix route and
    equals the butterfly; the wrapper refuses tables on another device and
    a limb list of the wrong length."""
    mods = boot_params(16).moduli[:6]
    ctx = NttContext(mods, 12, "cuda", backend="mxu")
    bfly = NttContext(mods, 12, "cuda")
    x = _residues(mods, (2, 6, 1 << 12), np.random.default_rng(8), "cuda")
    idx = tuple(range(6))
    before = mxu_kernel.STATS_FWD.launches
    assert torch.equal(ctx.ntt(x, idx), bfly.ntt(x, idx))
    assert mxu_kernel.STATS_FWD.launches == before + 1
    with pytest.raises(ValueError, match="limbs"):
        mxu_kernel.mxu_cuda(x, idx[:5], ctx.mxu_tables(), False)
    cpu_tabs = NttContext(mods, 12, "cpu", backend="mxu").mxu_tables()
    with pytest.raises(ValueError, match="tables on cpu"):
        mxu_kernel.mxu_cuda(x, idx, cpu_tabs, False)


def test_mxu_route_auto_on_card(dev):
    """"auto" at logN 16: a call over 12 limbs launches the matrix kernel,
    one over 13 launches K2; at logN 12 both launch K2; the results equal."""
    mods = boot_params(16).moduli
    rng = np.random.default_rng(3)
    for log_n, want12 in ((16, "mxu"), (12, "butterfly")):
        ctx = NttContext(mods, log_n, dev, backend="auto")
        bfly = NttContext(mods, log_n, dev)
        for limbs, want in ((12, want12), (13, "butterfly")):
            idx = tuple(range(limbs))
            assert ctx.resolved_backend(idx) == want
            a = _residues([mods[i] for i in idx], (limbs, 1 << log_n), rng, dev)
            counts = [s.launches for s in (mxu_kernel.STATS_FWD,
                                           ntt_kernel.STATS_FWD)]
            assert torch.equal(ctx.ntt(a, idx), bfly.ntt(a, idx))
            assert ([mxu_kernel.STATS_FWD.launches - counts[0],
                     ntt_kernel.STATS_FWD.launches - counts[1]]
                    == ([1, 1] if want == "mxu" else [0, 2]))


RNS_CASES = ["digits27", "digits15", "digits5", "digits0", "stack",
             "p_to_q27", "p_to_q0", "mod_raise", "rank_rows"]


def _rns_case(case, dev):
    """(extender, input, whether the output has a digit axis) of one call
    pattern of the basis extension at logN 16: the ModUp of each level's
    digits, a [2, L, N] stack, the mod-down's P → Q, ``mod_raise``'s
    (0,) → all and a tp-4 rank's destination rows."""
    from optimal_conv_tpu_torch.parallel.limbs import LimbPlacement

    p = boot_params(16)
    rng = np.random.default_rng(17)
    if case.startswith("digits") or case in ("stack", "rank_rows"):
        level = int(case[6:]) if case.startswith("digits") else 27
        dst = p.qp_idx(level)
        if case == "rank_rows":
            pl = LimbPlacement(p, 4)
            dst = pl.q_rows(level, 1) + pl.p_rows(1)
        ext = rns.DigitExtender(p.digits(level), dst, p.moduli, dev)
        lead = (2,) if case == "stack" else ()
        mods = [p.moduli[i] for i in p.q_idx(level)]
        return ext, _raised(mods, lead, rng, dev), True
    if case == "mod_raise":
        src, dst = (0,), p.q_idx(p.max_level)
    else:
        src, dst = p.p_idx(), p.q_idx(int(case[6:]))
    ext = rns.BasisExtender([p.moduli[i] for i in src],
                            [p.moduli[i] for i in dst], dev)
    mods = [p.moduli[i] for i in src]
    return ext, _raised(mods, (), rng, dev), False


def _raised(mods, lead, rng, dev):
    """[*lead, L, N] residues (0 and q-1 in every row) whose last quarter
    of columns is a polynomial raised from q0: one integer in
    (-q0/2, q0/2) a column, where the float32 count sits within a
    rounding of an integer."""
    n = 1 << 16
    x = _residues(mods, lead + (len(mods), n), rng, dev)
    q0 = boot_params(16).q_moduli[0]
    small = torch.from_numpy(rng.integers(-(q0 // 2), q0 // 2,
                                          size=lead + (n // 4,))).to(dev)
    for j, q in enumerate(mods):
        x[..., j, n - n // 4:] = torch.remainder(small, q)
    return x


@pytest.mark.parametrize("case", RNS_CASES)
def test_rns_extend_kernel_equals_plain(dev, case):
    """One launch of the basis extension kernel, equal to the plain chain
    (``extend_plain`` / ``extend_digits_plain``) residue for residue,
    max_abs_err 0, with no plain call."""
    ext, x, digit_axis = _rns_case(case, dev)
    call = ext.extend_digits if digit_axis else ext.extend
    plain = ext.extend_digits_plain if digit_axis else ext.extend_plain
    before = rns_kernel.STATS.launches, rns_kernel.STATS.plain_calls
    got = call(x)
    assert (rns_kernel.STATS.launches, rns_kernel.STATS.plain_calls) == (
        before[0] + 1, before[1])
    want = plain(x)
    assert got.shape == want.shape and got.is_cuda
    assert float((got - want).abs().max()) == 0.0
    assert torch.equal(got, want)


def test_rns_extend_kernel_rejects_bad_input(dev):
    """A CPU tensor, another dtype, a non-unit stride along N and a digit
    of more than MAX_ALPHA limbs are refused, never run another way."""
    p = boot_params(16)
    rng = np.random.default_rng(5)
    ext = rns.DigitExtender(p.digits(5), p.qp_idx(5), p.moduli, dev)
    mods = [p.moduli[i] for i in p.q_idx(5)]
    x = _residues(mods, (len(mods), p.n), rng, dev)
    with pytest.raises(ValueError):
        rns_kernel.extend_cuda(ext, x.cpu(), True)
    with pytest.raises(TypeError):
        ext.extend_digits(x.to(torch.int32))
    wide = _residues(mods, (len(mods), 2 * p.n), rng, dev)
    with pytest.raises(ValueError):
        ext.extend_digits(wide[..., ::2])
    nine = rns.BasisExtender(p.moduli[:9], p.moduli[9:12], dev)
    with pytest.raises(ValueError):
        nine.extend(_residues(p.moduli[:9], (9, p.n), rng, dev))


def test_kernels_reject_bad_input(dev):
    mods = boot_params(10).moduli[:2]
    q, qinv, _, _ = mm.limb_tables(mods, dev)
    a = torch.zeros(2, 1024, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        mont_kernel.mont_mul_cuda(a, a, q, qinv)
    with pytest.raises(TypeError):
        mont_kernel.mont_mul_cuda(q, q, q, qinv.cpu())
    with pytest.raises(ValueError):      # q must be constant along a row
        mont_kernel.mont_mul_cuda(a.long(), a.long(), a.long(), qinv)
    ctx = NttContext(mods, 10, dev)
    with pytest.raises(ValueError):
        ctx.ntt(torch.zeros(2, 512, dtype=torch.int64, device=dev))


@pytest.fixture(scope="module")
def contexts(dev):
    """The fork's chain at logN 12 on the CPU and on the card, with the
    same secret key and two ciphertexts encrypted once, on the CPU."""
    p = boot_params(12)
    cpu = CkksContext(p, "cpu", seed=4)
    card = CkksContext(p, dev, seed=4)
    rng = np.random.default_rng(4)
    cts = [cpu.encrypt(cpu.encoder.encode_slots(rng.uniform(-1, 1, p.slots),
                                                p.scale, 15)) for _ in range(2)]
    return cpu, card, cts


def _to_card(ct, dev):
    return type(ct)(ct.c0.to(dev), ct.c1.to(dev), level=ct.level, scale=ct.scale)


def _share_keys(cpu, card):
    """Switching keys are drawn by a generator of the context's device, so
    the card takes copies of the CPU context's."""
    for key, swk in cpu.switching_keys.items():
        card.switching_keys[key] = SwitchingKey(
            swk.d0.to(card.device), swk.d1.to(card.device), swk.level)


def _same_ct(got, want):
    assert (got.level, got.scale) == (want.level, want.scale)
    assert torch.equal(got.c0.cpu(), want.c0) and torch.equal(got.c1.cpu(), want.c1)


def test_mul_ct_on_card_equals_cpu(dev, contexts):
    """ct x ct with relinearisation at level 15 (four digits, the last of
    one limb), then the rescale: the card's residues equal the CPU's."""
    cpu, card, (a, b) = contexts
    want = cpu.rescale(cpu.mul_ct(a, b))
    _share_keys(cpu, card)
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV,
             rns_kernel.STATS, mod_add_kernel.STATS)
    before = [(s.launches, s.plain_calls) for s in stats]
    got = card.rescale(card.mul_ct(_to_card(a, dev), _to_card(b, dev)))
    for s, (launches, plain) in zip(stats, before):
        assert s.launches > launches and s.plain_calls == plain
    _same_ct(got, want)


@pytest.mark.parametrize("level", [15, 2])
def test_rotate_hoisted_on_card_equals_cpu(dev, contexts, level):
    cpu, card, (a, _) = contexts
    a = cpu.drop_level(a, 15 - level)
    rots = [0, 1, 2, 4, -3]
    want = cpu.rotate_hoisted(a, rots)
    _share_keys(cpu, card)
    got = card.rotate_hoisted(_to_card(a, dev), rots)
    for k in rots:
        _same_ct(got[k], want[k])
    lazy_want = cpu.rotate_hoisted_lazy(a, rots[:2])
    lazy_got = card.rotate_hoisted_lazy(_to_card(a, dev), rots[:2])
    for k in rots[:2]:
        for g, w in zip(lazy_got[k], lazy_want[k]):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("dh", [False, True], ids=["single", "double"])
def test_linear_transform_on_card_equals_cpu(dev, contexts, dh):
    """One BSGS transform at level 27 (six key-switch digits), in both
    forms: identity baby, key-switched babies, giants with a subset of the
    babies.  The card's residues equal the CPU's."""
    from optimal_conv_tpu_torch.ckks.bootstrap import LinearTransform

    cpu, card, _ = contexts
    p = cpu.params
    rng = np.random.default_rng(8)
    diags = {k: rng.uniform(-1, 1, p.slots) + 1j * rng.uniform(-1, 1, p.slots)
             for k in (0, 1, 2, 5, 9, 12)}
    ct = cpu.encrypt(cpu.encoder.encode_slots(rng.uniform(-1, 1, p.slots),
                                              p.scale, 27))
    lt_cpu = LinearTransform(cpu, diags, 27, double_hoist=dh)
    lt_card = LinearTransform(card, diags, 27, double_hoist=dh)
    for (_, _, a, _), (_, _, b, _) in zip(lt_cpu.stacked, lt_card.stacked):
        assert torch.equal(b.cpu(), a)
    want = lt_cpu(ct)
    _share_keys(cpu, card)
    held = len(card.switching_keys)
    got = lt_card(_to_card(ct, dev))
    assert len(card.switching_keys) == held
    _same_ct(got, want)


def test_bootstrap_on_card_equals_cpu(dev, contexts):
    """ctos -> stoc at log_sparse 2 on the fork's chain at logN 12: every
    ciphertext the card returns equals the CPU's, and the coefficients
    come back."""
    from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper

    cpu, card, _ = contexts
    p = cpu.params
    ls = 2
    b_cpu = SplitBootstrapper(cpu, log_sparse=ls)
    b_card = SplitBootstrapper(card, log_sparse=ls)
    v = np.zeros(p.n)
    v[:: 1 << ls] = np.random.default_rng(9).uniform(-1, 1, p.n >> ls)
    ct = cpu.encrypt(cpu.encoder.encode_coeffs(v, b_cpu.delta0, 0))
    mid, none = b_cpu.ctos(ct)
    want = b_cpu.stoc(mid, None)
    _share_keys(cpu, card)
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV,
             mod_add_kernel.STATS)
    before = [(s.launches, s.plain_calls) for s in stats]
    got_mid, got_none = b_card.ctos(_to_card(ct, dev))
    got = b_card.stoc(got_mid, None)
    for s, (launches, plain) in zip(stats, before):
        assert s.launches > launches
    assert mod_add_kernel.STATS.plain_calls == before[-1][1]
    assert none is None and got_none is None
    _same_ct(got_mid, mid)
    _same_ct(got, want)
    assert got.level == 1
    np.testing.assert_allclose(card.decrypt_decode_coeffs(got), v, atol=3e-2)


class _TwoLayers(Exception):
    pass


def _first_two_layers(ctx, monkeypatch, runner_cls="ResNetRunner"):
    """The ResNet-8 mini of tests/test_resnet_mini.py (or, for
    ``FastResNetRunner``, of tests/test_resnet_fast_mini.py) through the
    runner, stopped after its first two fused layers: → their output
    ciphertexts."""
    from optimal_conv_tpu_torch.models import resnet as res
    from optimal_conv_tpu_torch.models.plain import random_weights

    cfg = res.ResNetConfig(ker_wid=3, depth=8, in_wids=(16, 8, 4),
                           real_batch=(1, 2, 4), fc_out=4, init_pow=4.0,
                           mid_pow=4.0, final_pow=4.0)
    runner = getattr(res, runner_cls)(ctx, cfg, dict(k_range=12.0, sin_deg=31,
                                                     double_angle=3))
    w = random_weights(3, 8, cfg.real_batch, fc_out=4, in_ch=1, seed=4,
                       scale=0.7)
    image = np.random.default_rng(6).uniform(-1, 1, (15, 15, 1))
    outs = []
    layer = res.eval_conv_bn_relu

    def two(*args, **kw):
        if len(outs) == 2:
            raise _TwoLayers
        outs.append(layer(*args, **kw))
        return outs[-1]

    monkeypatch.setattr(res, "eval_conv_bn_relu", two)
    with pytest.raises(_TwoLayers):
        runner.infer(image, w)
    monkeypatch.setattr(res, "eval_conv_bn_relu", layer)
    return outs


def test_runner_layers_on_card_equal_cpu(dev, monkeypatch):
    """The runner's first two layers (Conv_sparse at log_sparse 2: conv,
    ctos, ReLU, repack, stoc) at logN 10 on the card equal the CPU's bit
    for bit, on the CPU context's keys.  The same seed gives both contexts
    the same secret key and the same encrypted image."""
    p = mini_boot_params(10, n_relu=14)
    cpu = CkksContext(p, "cpu", seed=19)
    card = CkksContext(p, dev, seed=19)
    want = _first_two_layers(cpu, monkeypatch)
    _share_keys(cpu, card)
    held = len(card.switching_keys)
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV)
    before = [(s.launches, s.plain_calls) for s in stats]
    got = _first_two_layers(card, monkeypatch)
    for s, (launches, plain) in zip(stats, before):
        assert s.launches > launches and s.plain_calls == plain
    assert len(card.switching_keys) == held, "the card made a key"
    for g, w_ in zip(got, want):
        _same_ct(g, w_)
    assert [c.level for c in got] == [1, 1]


def test_fast_runner_layers_on_card_equal_cpu(dev, monkeypatch):
    """FastResNetRunner's first two layers (Conv_inside at log_sparse 0:
    two ciphertexts out of ctos, two ReLUs, the stride-1 keep masks) at
    logN 10 on the card equal the CPU's bit for bit, on the CPU context's
    keys."""
    p = mini_boot_params(10, n_relu=14)
    cpu = CkksContext(p, "cpu", seed=19)
    card = CkksContext(p, dev, seed=19)
    want = _first_two_layers(cpu, monkeypatch, "FastResNetRunner")
    _share_keys(cpu, card)
    held = len(card.switching_keys)
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV)
    before = [(s.launches, s.plain_calls) for s in stats]
    got = _first_two_layers(card, monkeypatch, "FastResNetRunner")
    for s, (launches, plain) in zip(stats, before):
        assert s.launches > launches and s.plain_calls == plain
    assert len(card.switching_keys) == held, "the card made a key"
    for g, w_ in zip(got, want):
        _same_ct(g, w_)
    assert [c.level for c in got] == [1, 1]


class _ConvDone(Exception):
    pass


def _wide3_calls(runner, image_ct, conv_only):
    """``WideFastResNetRunner.infer`` at wide 3 from the ciphertext
    `image_ct`, through its first layer and both ``StrConv_odd`` halves;
    block 1's other layers hand on their input.  With `conv_only` each of
    the three stops at its conv stage's end.  → the three outputs (conv
    stages or whole layers) and the runner's sum of the halves (None with
    `conv_only`)."""
    from optimal_conv_tpu_torch.models import resnet as res
    from optimal_conv_tpu_torch.models.plain import random_weights

    cfg = runner.cfg
    runner.encrypt_image = lambda image: image_ct
    w = random_weights(3, cfg.depth, cfg.real_batch, fc_out=cfg.fc_out,
                       in_ch=3, seed=8, scale=0.7, init_batch=cfg.init_batch)
    layer, outs, kinds = res.eval_conv_bn_relu, [], []

    def stop_at_conv(stage, value):
        if stage == "conv":
            raise _ConvDone(value)

    def calls(*args):
        kinds.append(args[18])
        if len(kinds) > 1 and kinds[-1] != "StrConv_odd":
            if kinds[-2] == "StrConv_odd":
                raise _TwoLayers(args[2])
            return args[2]
        if not conv_only:
            outs.append(layer(*args))
            return outs[-1]
        try:
            layer(*args, debug_hook=stop_at_conv)
        except _ConvDone as done:
            outs.append(done.args[0])
        return args[2]
    res.eval_conv_bn_relu = calls
    try:
        with pytest.raises(_TwoLayers) as stop:
            runner.infer(np.zeros((cfg.raw_in_wids[0],) * 2 + (3,)), w)
    finally:
        res.eval_conv_bn_relu = layer
    assert [k for k in kinds if k != "Conv"] == ["StrConv_odd"] * 2 + [
        "Conv_inside"]
    return outs, None if conv_only else stop.value.args[0]


@pytest.mark.parametrize("size", ["mini", "cell"])
def test_wide3_layers_on_card_equal_cpu(dev, size):
    """``WideFastResNetRunner`` at wide 3: the first layer (full-pack
    ``Conv``) and both ``StrConv_odd`` halves on the card equal the
    CPU's bit for bit, on the CPU context's keys.  At the ResNet-8
    miniature (logN 10, real_batch (3, 6, 12)) the whole fused layers
    and the runner's sum of the halves; at the cell's sizes (logN 16,
    real_batch (48, 96, 192), init_batch 16: 64 kernel plaintexts a
    conv) their conv stages, the CPU's bootstrap at logN 16 being out of
    a test's reach."""
    from optimal_conv_tpu_torch.models import resnet as res

    if size == "mini":
        p = mini_boot_params(10, n_relu=14)
        cfg = res.ResNetConfig(ker_wid=3, depth=8, in_wids=(16, 8, 4),
                               real_batch=(3, 6, 12), wide=3, init_batch=2,
                               fc_out=4, init_pow=4.0, mid_pow=4.0,
                               final_pow=4.0)
        boot = dict(k_range=12.0, sin_deg=31, double_angle=3)
    else:
        p = boot_params(16)
        cfg = res.ResNetConfig(depth=20, wide=3, real_batch=(48, 96, 192),
                               init_batch=16)
        boot = None
    conv_only = size == "cell"
    # whole keys: the card takes copies of the CPU's (about 3 min of the
    # CPU's plain arithmetic at logN 16 for the three convs)
    cpu = CkksContext(p, "cpu", seed=29, compress_keys=False)
    card = CkksContext(p, dev, seed=29, compress_keys=False)
    runners = [res.WideFastResNetRunner(c, cfg, boot) for c in (cpu, card)]
    raw0 = cfg.raw_in_wids[0]
    ct = runners[0].encrypt_image(
        np.random.default_rng(31).uniform(-1, 1, (raw0, raw0, 3)))
    want, want_sum = _wide3_calls(runners[0], ct, conv_only)
    _share_keys(cpu, card)
    held = len(card.switching_keys)
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV)
    before = [(s.launches, s.plain_calls) for s in stats]
    got, got_sum = _wide3_calls(runners[1], _to_card(ct, dev), conv_only)
    for s, (launches, plain) in zip(stats, before):
        assert s.launches > launches and s.plain_calls == plain
    assert len(card.switching_keys) == held, "the card made a key"
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        _same_ct(g, w_)
    if conv_only:
        assert [c.level for c in got] == [0, 0, 0]
    else:
        assert [c.level for c in got] == [1, 1, 1]
        _same_ct(got_sum, want_sum)


def test_conv_bn_bl_on_card_equals_cpu(dev):
    """One baseline conv (ops.baseline.eval_conv_bn_bl: nine hoisted
    rotations, the masked tap products, a rotated out-channel offset and
    the bias) at logN 10 on the card equals the CPU's bit for bit."""
    from optimal_conv_tpu_torch.ckks.params import CkksParams
    from optimal_conv_tpu_torch.ops import baseline as bl

    p = CkksParams(log_n=10, logq=(50, 40), logp=(55,), log_scale=30, h=64)
    cpu = CkksContext(p, "cpu", seed=23)
    card = CkksContext(p, dev, seed=23)
    rng = np.random.default_rng(55)
    in_wid, ch = 16, 2
    img = np.zeros((in_wid, in_wid, ch))
    img[:15, :15] = rng.uniform(-1, 1, (15, 15, ch))
    ker = rng.uniform(-1, 1, (3, 3, ch, ch)) / 4
    bn_a, bn_b = rng.uniform(0.8, 1.2, ch), rng.uniform(-0.3, 0.3, ch)
    slots = bl.reshape_input_bl(img.ravel(), in_wid)
    ct = cpu.encrypt(cpu.encoder.encode_slots(slots, p.scale, 1))
    args = (ker.ravel(), bn_a, bn_b, in_wid, 3, ch, ch, 1)
    want = bl.eval_conv_bn_bl(cpu, ct, *args)
    _share_keys(cpu, card)
    held = len(card.switching_keys)
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV)
    before = [(s.launches, s.plain_calls) for s in stats]
    got = bl.eval_conv_bn_bl(card, _to_card(ct, dev), *args)
    for s, (launches, plain) in zip(stats, before):
        assert s.launches > launches and s.plain_calls == plain
    assert len(card.switching_keys) == held, "the card made a key"
    _same_ct(got, want)


# (in_wid, ker_wid, real_ib, real_ob, norm, in_norm) at logN 16
KERNEL_GEOMS = {
    "resnet20_block3": (8, 3, 64, 64, 16, None),
    "tail_head_cut": (8, 7, 512, 64, 1, 2),     # the RMFC head, 64 logits
}


@pytest.mark.parametrize("geom", list(KERNEL_GEOMS))
def test_prep_ker_batched_on_card(dev, geom, monkeypatch):
    """``prep_ker``'s batched pass on the card at logN 16 equals the
    per-plaintext host composition (and, for the block-3 conv, the CPU's
    batched pass) residue for residue; ``conv_then_pack`` hands its
    tensor to the pack without a copy; and prep + pack peak no higher
    than the per-plaintext path's prep + pack, each warm."""
    from optimal_conv_tpu_torch.ops import conv as convops

    in_wid, kw, rib, rob, norm, in_norm = KERNEL_GEOMS[geom]
    p = boot_params(16)
    card = CkksContext(p, dev, seed=5)
    rng = np.random.default_rng(19)
    ker = rng.uniform(-1, 1, kw * kw * rib * rob) / kw
    bn_a = rng.uniform(0.8, 1.2, rob)
    max_bat = p.n // (in_wid * in_wid)
    rows = range(0, max_bat, norm)

    def batched():
        return convops.prep_ker(card, ker, bn_a, in_wid, kw, rib, rob, norm,
                                False, in_norm)

    def host():
        return convops._prep_ker_host(card, ker, bn_a, in_wid, kw, rib, rob,
                                      norm, False, in_norm or norm)

    got, want = batched(), host()
    for i in rows:
        assert torch.equal(got[i].poly, want[i].poly), i
    if geom == "resnet20_block3":
        cpu = convops.prep_ker(CkksContext(p, "cpu", seed=5), ker, bn_a,
                               in_wid, kw, rib, rob, norm, False, in_norm)
        for i in rows:
            assert torch.equal(got[i].poly.cpu(), cpu[i].poly), i
    del got, want

    seen = []
    real_pack = convops._conv_pack

    def pack(ctx, c0, c1, pls, *rest):
        seen.append(pls.data_ptr())
        return real_pack(ctx, c0, c1, pls, *rest)
    monkeypatch.setattr(convops, "_conv_pack", pack)
    ct = card.encrypt(card.encoder.encode_coeffs(
        rng.uniform(-1, 1, p.n), p.scale, convops.ECD_LEVEL))
    bias = card.encoder.encode_coeffs(np.zeros(p.n), float(1 << 30), 0,
                                      mont=False)

    def conv(prep):
        pl = prep()
        out = convops.conv_then_pack(card, ct, pl, max_bat, norm,
                                     float(1 << 30), bias)
        return out, getattr(pl, "polys", None)

    conv(batched)                       # keys made, caches filled
    outs, peaks = {}, {}
    for name, prep in (("host", host), ("batched", batched)):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        outs[name], polys = conv(prep)
        torch.cuda.synchronize(dev)
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
        if polys is not None:
            assert seen[-1] == polys.data_ptr()
        del polys
    print(f"{geom}: prep_ker + conv_then_pack peak above the base, bytes: "
          f"{peaks}")
    assert peaks["batched"] <= peaks["host"], peaks
    assert torch.equal(outs["batched"].c0, outs["host"].c0)
    assert torch.equal(outs["batched"].c1, outs["host"].c1)


def _kernel_moves(fn):
    """fn() and the launches, by rows, it counted on the main kernels."""
    stats = (mont_kernel.STATS, ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV,
             rns_kernel.STATS, mod_add_kernel.STATS)
    before = [(s.launches, dict(s.by_rows)) for s in stats]
    out = fn()
    return out, [(s.name, s.launches - n,
                  {r: c - rows.get(r, 0) for r, c in s.by_rows.items()
                   if c != rows.get(r, 0)}) for s, (n, rows) in zip(stats, before)]


def _same_card(got, want):
    assert (got.level, got.scale) == (want.level, want.scale)
    assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)


@pytest.fixture(scope="module")
def graph_ctx(dev):
    """The fork's chain at logN 12 on the card, a full-slot and a sparse
    bootstrapper, and three ciphertexts at EvalMod's input level."""
    from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper

    p = boot_params(12)
    ctx = CkksContext(p, dev, seed=11)
    btps = {ls: SplitBootstrapper(ctx, log_sparse=ls) for ls in (0, 2)}
    rng = np.random.default_rng(11)
    b = btps[0]
    cts = [ctx.encrypt(ctx.encoder.encode_slots(
        rng.uniform(-1, 1, p.slots) / b.k_range, b.delta_m, b.post_ctos_level))
        for _ in range(3)]
    return ctx, btps, cts


@pytest.mark.parametrize("ls", [0, 2], ids=["full", "sparse"])
def test_eval_mod_and_relu_graphs_replay_eager(dev, graph_ctx, ls):
    """EvalMod and the ReLU as CUDA graphs: the first call captures, later
    calls replay on other inputs, and every output equals the eager body's
    residue for residue; a replay credits the kernel counters with the
    eager call's launches, by rows; an output stays intact while other
    graphs replay."""
    from optimal_conv_tpu_torch.ops.relu import _relu, eval_relu

    ctx, btps, cts = graph_ctx
    btp = btps[ls]
    want = [btp._eval_mod_body(c) for c in cts]
    before = tracing.counters()
    first = btp._eval_mod(cts[0])                 # eager, capture, replay
    _, eager = _kernel_moves(lambda: btp._eval_mod_body(cts[1]))
    second, replayed = _kernel_moves(lambda: btp._eval_mod(cts[1]))
    third = btp._eval_mod(cts[2])
    assert replayed == eager
    after = tracing.counters()
    for name, n in (("graph.eager", 1), ("graph.captures", 1),
                    ("graph.replays", 2)):
        assert after.get(name, 0) - before.get(name, 0) == n, name
    for got, w in zip((first, second, third), want):
        _same_card(got, w)
    relu_want = [_relu(ctx, w, 0.0, None) for w in want]
    relu_got = [eval_relu(ctx, w) for w in want]
    _, eager = _kernel_moves(lambda: _relu(ctx, want[0], 0.0, None))
    _, replayed = _kernel_moves(lambda: eval_relu(ctx, want[0]))
    assert replayed == eager
    for got, w in zip(relu_got, relu_want):
        _same_card(got, w)
    _same_card(second, want[1])                   # after the ReLU's replays


def test_eval_mod_graph_replays_the_mod_add_kernel(dev, graph_ctx):
    """EvalMod's graph holds the additive kernel: a replay credits
    ``kernel.mod_add.launches`` with the eager call's launches, by rows,
    calls no plain version, and equals the eager body bit for bit."""
    ctx, btps, cts = graph_ctx
    btp = btps[0]
    want = btp._eval_mod_body(cts[2])
    btp._eval_mod(cts[0])                         # captured here or earlier
    _, eager = _kernel_moves(lambda: btp._eval_mod_body(cts[1]))
    before = tracing.counters()
    got, replayed = _kernel_moves(lambda: btp._eval_mod(cts[2]))
    after = tracing.counters()
    assert after.get("graph.replays", 0) - before.get("graph.replays", 0) == 1
    assert replayed == eager
    (launches,) = [n for name, n, _ in replayed if name == "mod_add"]
    assert launches > 0
    key = "kernel.mod_add."
    assert after[key + "launches"] - before[key + "launches"] == launches
    assert after[key + "plain_calls"] == before[key + "plain_calls"]
    _same_card(got, want)


def test_graphs_add_under_32_mib(dev):
    """At logN 16, EvalMod of the full-slot bootstrapper and the ReLU
    after it, captured on a warm context: what stays allocated beyond
    their outputs is the shared input buffer, under 32 MiB."""
    from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper
    from optimal_conv_tpu_torch.ops.relu import _relu, eval_relu

    p = boot_params(16)
    ctx = CkksContext(p, dev, seed=12)
    btp = SplitBootstrapper(ctx, log_sparse=0)
    x = np.random.default_rng(12).uniform(-1, 1, p.slots) / btp.k_range
    ct = ctx.encrypt(ctx.encoder.encode_slots(x, btp.delta_m,
                                              btp.post_ctos_level))
    _relu(ctx, btp._eval_mod_body(ct), 0.0, None)      # keys and columns
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    reserved = torch.cuda.memory_reserved(dev)
    mid = btp._eval_mod(ct)
    out = eval_relu(ctx, mid)
    torch.cuda.synchronize(dev)
    outs = sum(t.numel() * 8 for c in (mid, out) for t in (c.c0, c.c1))
    added = torch.cuda.memory_allocated(dev) - base - outs
    print(f"graphs at logN 16: {added} bytes allocated beyond the outputs "
          f"(buffer {ctx._graphs.buf.numel() * 8}), reserved "
          f"{torch.cuda.memory_reserved(dev) - reserved:+d} bytes, EvalMod "
          f"input level {ct.level}")
    assert added < 32 << 20
    _same_card(btp._eval_mod(ct), mid)
