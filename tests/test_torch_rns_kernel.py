"""The RNS basis extension kernel's tables and launch plans, on the CPU.

``csrc/rns_extend.cu`` cannot run without a card, but what it computes
for one output column is integer and float arithmetic that numpy repeats
exactly.  ``_emulate`` below re-enacts the kernel, reading only the
packed table (``rns_kernel.pack``) and the launch that ``rns_kernel.plan``
describes: the block → (lead, digit) and thread → column mapping, the
Montgomery y_j, the float32 count one rounding a step, the 128-bit sum
of products with one REDC a row and the v·Q subtraction.  It must write
every output element once and equal the extenders' plain chains
(``extend_digits``, ``extend``) bit for bit: for the key switch's ModUp
and the mod-down's P → Q at levels 27, 15, 5 and 0 of the fork's chain,
for ``mod_raise``'s (0,) → all, and on columns planted where the count
is hardest (0, q − 1, and a polynomial raised from q0, whose count sits
within a float32 rounding of an integer: F2).
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.params import boot_params
from optimal_conv_tpu_torch.core import rns
from optimal_conv_tpu_torch.core import rns_kernel as rk
from optimal_conv_tpu_torch.parallel.limbs import LimbPlacement
from optimal_conv_tpu_torch.utils import tracing

torch.set_num_threads(1)

P = boot_params(12)
N_COLS = 300                 # two full blocks of 128 and a ragged third
LEVELS = [27, 15, 5, 0]      # digits (5,5,5,5,5,3), (5,5,5,1), (5,1), (1)
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


def _mulhi(a, b):
    """High 64 bits of the 128-bit products of uint64 arrays."""
    al, ah, bl, bh = a & M32, a >> S32, b & M32, b >> S32
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    cross = (ll >> S32) + (lh & M32) + (hl & M32)
    return hh + (lh >> S32) + (hl >> S32) + (cross >> S32)


def _mont_mul(a, b, q, qinv):
    lo = a * b
    r = _mulhi(a, b) + _mulhi(lo * qinv, q) + (lo != 0).astype(np.uint64)
    return np.where(r >= q, r - q, r)


def _flat(t):
    """The whole storage of t as flat uint64, and t's offset in it."""
    flat = torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())
    return flat.numpy().view(np.uint64), t.storage_offset()


def _emulate(words, launch, x):
    """csrc/rns_extend.cu in numpy: (out, visits), both flat [items·R·n]."""
    L = launch
    a, r, n = L.alpha, L.r, L.n
    lay = rk.layout(a, r)
    flat, off = _flat(x)
    items = L.lead * L.beta
    out = np.zeros(items * r * n, dtype=np.uint64)
    visits = np.zeros(items * r * n, dtype=np.int64)
    for bz in range(L.gz):
        for by in range(L.gy):
            item = bz * L.gy + by
            if item >= items:
                continue
            lead, digit = divmod(item, L.beta)
            s = words[digit].view(np.uint64)

            def part(name):
                at, k = lay[name]
                return s[at:at + k]

            inv = part("inv_bits").astype(np.uint32).view(np.float32)
            for bx in range(L.gx):
                col = bx * L.threads + np.arange(L.threads)
                col = col[col < n]
                base = off + lead * L.lead_stride + col
                v = np.zeros(col.size, dtype=np.float32)
                ys = []
                for j in range(a):
                    xj = flat[base + int(part("gather")[j]) * L.row_stride]
                    y = _mont_mul(xj, part("qhat_inv")[j], part("q")[j],
                                  part("qinv")[j])
                    ys.append(y)
                    yf = y.astype(np.int64).astype(np.float32)
                    v = (yf.astype(np.float64) * np.float64(inv[j])
                         + v.astype(np.float64)).astype(np.float32)
                vi = np.clip(np.floor(v).astype(np.int64), 0, a)
                for i in range(r):
                    lo = np.zeros(col.size, dtype=np.uint64)
                    hi = np.zeros(col.size, dtype=np.uint64)
                    for j in range(a):
                        b = part("qhat")[j * r + i]
                        pl = ys[j] * b
                        lo = lo + pl
                        hi = hi + _mulhi(ys[j], b) + (lo < pl).astype(np.uint64)
                    q = part("rq")[i]
                    acc = (hi + _mulhi(lo * part("rqinv")[i], q)
                           + (lo != 0).astype(np.uint64))
                    assert (acc < 3 * q).all()
                    acc = np.where(acc >= 2 * q, acc - 2 * q, acc)
                    acc = np.where(acc >= q, acc - q, acc)
                    vq = part("vq")[i * (a + 1) + vi]
                    idx = item * r * n + i * n + col
                    out[idx] = np.where(acc >= vq, acc - vq, acc + q - vq)
                    visits[idx] += 1
    return out, visits


def _kernel_model(ext, x, digit_axis):
    """What the kernel would return for `ext` on x, through its plan."""
    tab = rk.Table(ext.spec, "cpu")
    pl = rk.plan(tab.alpha, tab.beta, tab.r, tab.in_rows, digit_axis,
                 tuple(x.shape), x.stride())
    if pl.copy:
        x = x.contiguous()
    out, visits = _emulate(tab.words.numpy(), pl.launch, x)
    assert (visits == 1).all()
    return torch.from_numpy(out.view(np.int64).reshape(pl.out_shape))


def _columns(mods, rng, n=N_COLS, lead=()):
    """[*lead, len(mods), n] residues: uniform columns, then 0, then q − 1,
    then the last third a polynomial raised from q0 (the residues of one
    integer in (−q0/2, q0/2) a column, as ``mod_raise`` leaves them)."""
    q0 = P.q_moduli[0]
    k = len(mods)
    out = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.int64)
                    for q in mods], axis=-2)
    out[..., 0] = 0
    out[..., 1] = np.array(mods, dtype=np.int64) - 1
    third = n // 3
    small = rng.integers(-(q0 // 2), q0 // 2, size=lead + (third,),
                         dtype=np.int64)
    for j in range(k):
        out[..., j, n - third:] = np.mod(small, mods[j])
    return torch.from_numpy(out)


def _digit_ext(level, dst=None):
    dst = P.qp_idx(level) if dst is None else tuple(dst)
    return rns.DigitExtender(P.digits(level), dst, P.moduli, "cpu")


def _basis_ext(src, dst):
    return rns.BasisExtender([P.moduli[i] for i in src],
                             [P.moduli[i] for i in dst], "cpu")


def test_layout_is_the_kernels():
    """The table's parts tile a row in the kernel's order, and its width
    is the one csrc/rns_extend.cu checks: 5α + R(2α + 3)."""
    for alpha, r in [(1, 1), (1, 6), (5, 33), (5, 24), (8, 64)]:
        lay = rk.layout(alpha, r)
        at = 0
        for name in ("gather", "q", "qinv", "qhat_inv", "inv_bits", "qhat",
                     "vq", "rq", "rqinv"):
            assert lay[name][0] == at
            at += lay[name][1]
        assert lay["width"] == at == 5 * alpha + r * (2 * alpha + 3)
    assert rk.layout(5, 33)["width"] * 8 < 4096


@pytest.mark.parametrize("level", LEVELS)
def test_pack_holds_the_plain_constants(level):
    """Every word of the packed table is the plain extender's constant:
    the gather, the source and destination Montgomery tables, q-hat, the
    float32 1/q and the v·Q table; a ragged digit's padding as the plain
    version pads it."""
    ext = _digit_ext(level)
    words = rk.pack(*ext.spec)
    lay = rk.layout(ext.alpha, ext.R)
    assert words.shape == (ext.beta, lay["width"])

    def part(name):
        at, k = lay[name]
        return torch.from_numpy(words[:, at:at + k])

    assert torch.equal(part("gather"), ext.gather)
    assert torch.equal(part("q"), ext.sq[..., 0])
    assert torch.equal(part("qinv"), ext.sqinv[..., 0])
    assert torch.equal(part("qhat_inv"), ext.qhat_inv_mont[..., 0])
    inv = part("inv_bits").numpy().astype(np.uint32).view(np.float32)
    assert np.array_equal(inv.astype(np.float64), ext.inv_src.numpy())
    qhat = part("qhat").reshape(ext.beta, ext.alpha, ext.R)
    assert torch.equal(qhat, ext.qhat_mont[..., 0].permute(1, 0, 2))
    assert torch.equal(part("vq").reshape(ext.beta, ext.R, ext.alpha + 1),
                       ext.qmod_table)
    assert torch.equal(part("rq"), ext.dq[0, :, 0].expand(ext.beta, -1))
    assert torch.equal(part("rqinv"), ext.dqinv[0, :, 0].expand(ext.beta, -1))


@pytest.mark.parametrize("level", LEVELS)
def test_model_equals_extend_digits(level):
    """ModUp: every digit of `level` into Q_level·P, the kernel's
    arithmetic against ``extend_digits``'s plain chain, bit for bit."""
    ext = _digit_ext(level)
    x = _columns([P.moduli[i] for i in P.q_idx(level)],
                 np.random.default_rng(level))
    want = ext.extend_digits(x)
    assert want.shape == (len(P.digits(level)), level + 1 + P.num_p, N_COLS)
    assert torch.equal(_kernel_model(ext, x, True), want)


@pytest.mark.parametrize("level", LEVELS)
def test_model_equals_p_to_q(level):
    """The mod-down's conversion of the P rows to Q_level (α = |P| = 5)."""
    ext = _basis_ext(P.p_idx(), P.q_idx(level))
    x = _columns(P.p_moduli, np.random.default_rng(100 + level))
    want = ext.extend(x)
    assert want.shape == (level + 1, N_COLS)
    assert torch.equal(_kernel_model(ext, x, False), want)


def test_model_equals_mod_raise_extension():
    """``mod_raise``'s extension of one q0 row to every Q limb (K = 1)."""
    ext = _basis_ext((0,), P.q_idx(P.max_level))
    x = _columns([P.q_moduli[0]], np.random.default_rng(7))
    want = ext.extend(x)
    assert torch.equal(_kernel_model(ext, x, False), want)


def test_raised_columns_test_the_count():
    """The planted raised-from-q0 columns put the count where its rounding
    decides it (F2): at level 27 the exact Σ y_j/q_j of most of them lies
    within 2^-20 of an integer, and the count the kernel takes there is
    the plain version's."""
    level = 27
    ext = _digit_ext(level)
    x = _columns([P.moduli[i] for i in P.q_idx(level)],
                 np.random.default_rng(level))
    third = N_COLS // 3
    for b, dig in enumerate(P.digits(level)):
        mods = [P.moduli[i] for i in dig]
        big_q = 1
        for q in mods:
            big_q *= q
        near = 0
        for col in range(N_COLS - third, N_COLS):
            xs = [int(x[i, col]) for i in dig]
            y = [xs[j] * pow(big_q // q % q, -1, q) % q
                 for j, q in enumerate(mods)]
            exact = sum(yj * (big_q // q) for yj, q in zip(y, mods))
            frac = exact % big_q
            near += min(frac, big_q - frac) < big_q >> 20
        assert near > third // 2, (b, near)
    assert torch.equal(_kernel_model(ext, x, True), ext.extend_digits(x))


def test_model_on_a_limb_sharded_rank():
    """A tp-4 rank's destination rows (``digit_extender(level, targets)``,
    parallel/limbs.py and sharding.py): a subset of Q_level·P."""
    level = 27
    pl = LimbPlacement(P, 4)
    targets = pl.q_rows(level, 1) + pl.p_rows(1)
    ext = _digit_ext(level, targets)
    x = _columns([P.moduli[i] for i in P.q_idx(level)],
                 np.random.default_rng(11))
    want = ext.extend_digits(x)
    assert want.shape[-2] == len(targets) < level + 1 + P.num_p
    assert torch.equal(_kernel_model(ext, x, True), want)
    whole = _digit_ext(level).extend_digits(x)
    rows = [P.qp_idx(level).index(i) for i in targets]
    assert torch.equal(want, whole[:, rows])


@pytest.mark.parametrize("view", ["stack", "strided_lead", "unmerged_lead",
                                  "row_slice"])
def test_model_on_leading_dims_and_views(view):
    """Leading dims (a [2, L, n] stack of c0/c1-like rows, a strided and
    an unmergeable lead, which the wrapper makes contiguous first) and a
    view whose rows step by more than n: equal to the plain chain."""
    level = 5
    ext = _digit_ext(level)
    mods = [P.moduli[i] for i in P.q_idx(level)]
    rng = np.random.default_rng(21)
    if view == "stack":
        x = _columns(mods, rng, lead=(2,))
    elif view == "strided_lead":
        x = _columns(mods, rng, lead=(4,))[::2]
    elif view == "unmerged_lead":
        x = _columns(mods, rng, lead=(2, 3))[:, :2]
    else:
        base = _columns(mods, rng)
        x = torch.stack([base, base + 1], dim=1).reshape(-1, N_COLS)[::2]
        assert torch.equal(x, base) and x.stride(-2) == 2 * N_COLS
    want = ext.extend_digits(x)
    tab = rk.Table(ext.spec, "cpu")
    pl = rk.plan(tab.alpha, tab.beta, tab.r, tab.in_rows, True,
                 tuple(x.shape), x.stride())
    assert pl.copy == (view == "unmerged_lead")
    assert torch.equal(_kernel_model(ext, x, True), want)


def test_plan_rejects_and_empties():
    """The plan raises on what the kernel does not take (a non-unit stride
    along N, too few input rows, a P → Q input of the wrong height) and
    launches nothing for an empty output."""
    ext = _digit_ext(15)
    tab = rk.Table(ext.spec, "cpu")
    x = torch.zeros(16, 64, dtype=torch.int64)
    args = (tab.alpha, tab.beta, tab.r, tab.in_rows, True)
    with pytest.raises(ValueError):
        rk.plan(*args, (16, 32), x[:, ::2].stride())
    with pytest.raises(ValueError):
        rk.plan(*args, (15, 64), (64, 1))
    with pytest.raises(ValueError):
        rk.plan(5, 1, 16, 5, False, (6, 64), (64, 1))
    empty = rk.plan(*args, (0, 16, 64), (1024, 64, 1))
    assert empty.launch is None and empty.out_shape == (0, 4, tab.r, 64)
    big = rk.plan(*args, (3, 16, 64), (1024, 64, 1))
    assert (big.launch.lead, big.launch.gy, big.launch.gx) == (3, 12, 1)
    assert big.rows == 3 * 4 * tab.r


@pytest.mark.parametrize("case", ["alpha", "rows", "even", "wide"])
def test_pack_rejects_what_the_kernel_does_not_take(case):
    """α above MAX_ALPHA, R above MAX_ROWS, an even modulus, one of 2^62
    or more: refused when the table is packed, before any launch."""
    q = P.q_moduli
    gather, src, dst = [tuple(range(5))], [tuple(q[:5])], tuple(q[5:10])
    if case == "alpha":
        gather, src = [tuple(range(9))], [tuple(q[:9])]
    elif case == "rows":
        dst = tuple(q) * 3
    elif case == "even":
        dst = dst + (q[0] + 1,)
    else:
        dst = dst + ((1 << 62) + 1,)
    with pytest.raises(ValueError):
        rk.pack(gather, src, dst)
    assert rk.MAX_ALPHA == 8 and rk.MAX_ROWS == 64


def test_cpu_runs_the_plain_chain():
    """On the CPU the extenders run their plain chains (counted as
    ``plain_calls``), launch nothing, and the wrapper refuses a CPU
    tensor and a tensor of another dtype."""
    ext = _digit_ext(0)
    bext = _basis_ext(P.p_idx(), P.q_idx(0))
    x = _columns([P.q_moduli[0]], np.random.default_rng(3))
    before = rk.STATS.launches, rk.STATS.plain_calls
    ext.extend_digits(x)
    bext.extend(_columns(P.p_moduli, np.random.default_rng(4)))
    assert (rk.STATS.launches, rk.STATS.plain_calls) == (before[0],
                                                         before[1] + 2)
    with pytest.raises(ValueError):
        rk.extend_cuda(ext, x, True)
    with pytest.raises(TypeError):
        rk.extend_cuda(ext, x.to(torch.int32), True)
    assert "kernel.rns_extend.plain_calls" in tracing.counters()
