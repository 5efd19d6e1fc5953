"""The launch plan of the CUDA additive modular kernel, and its plain twins,
on the CPU.

``csrc/mod_add.cu`` cannot run without a card, but which elements each
thread reads and writes, and the uint64 arithmetic it applies to them,
are integer arithmetic that a CPU can repeat.  ``mod_add_kernel.plan`` is
a pure function of the operation and the operands' shapes, strides and
16-byte alignment, so it is tested here on CPU tensors, and
``_model_kernel`` below re-enacts the kernel's block → row → offsets and
thread → column arithmetic, with the kernel's wrapped uint64 formulas, in
numpy: driven by a plan it must write every output element exactly once
and equal the plain versions of ``core.modmath``.
"""

import itertools

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.params import boot_params
from optimal_conv_tpu_torch.core import mod_add_kernel as ak
from optimal_conv_tpu_torch.core import modmath as mm

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores, so each worker keeps one.
torch.set_num_threads(1)

MODS = boot_params(12).moduli[:6]
N = 64


def _residues(shape, seed=0, mods=MODS):
    """Uniform residues [..., L, n] with 0 and q-1 in every row."""
    rng = np.random.default_rng(seed)
    out = np.stack([rng.integers(0, q, size=shape[:-2] + shape[-1:],
                                 dtype=np.int64) for q in mods[:shape[-2]]],
                   axis=-2)
    out[..., 0] = 0
    out[..., -1] = np.array(mods[:shape[-2]], dtype=np.int64) - 1
    return torch.from_numpy(out)


def _q(k=6):
    return mm.limb_tables(MODS[:k], "cpu")[0]


def _col(k=6, seed=9):
    """A [k, 1] column of residues, one a limb (add_const, q_top mod q)."""
    rng = np.random.default_rng(seed)
    return torch.tensor([[int(rng.integers(0, q))] for q in MODS[:k]])


def _coeffs(shape, seed, top=MODS[-1]):
    """A top limb's coefficients [..., 1, n] in [0, top), with the values
    around top // 2 that decide the centred correction."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, top, size=shape, dtype=np.int64)
    edge = [top // 2 - 1, top // 2, top // 2 + 1, top - 1]
    out.reshape(-1)[:4] = edge[:out.size]
    return torch.from_numpy(out)


def _cases(n=N):
    """The port's call patterns: name → (op, operands in the kernel's role
    order, keyword arguments of the plain version)."""
    q = _q()
    a = _residues((6, n), 1)
    b = _residues((6, n), 2)
    bb = _residues((3, 6, n), 3)
    dig = _residues((2, 3, 6, n), 4)                  # [lead, beta, R, n]
    stack = _residues((5, 6, n), 5)                   # [nb, L, n]
    wide = _residues((7, 6, n), 6)
    pk = torch.stack([_residues((1, n), s, MODS[:1]) for s in (7, 8, 9)])
    pk2 = torch.stack([_residues((1, n), s, MODS[:1]) for s in (10, 11, 12)])
    half = MODS[-1] // 2
    return {
        "add_rows": (ak.ADD, (a, b, q), {}),
        # add_const: a cached [L, 1] column
        "add_col": (ak.ADD, (a, _col(), q), {}),
        "add_lead_bcast": (ak.ADD, (a[None], bb, q), {}),
        # _ks_core's digit views t0[..., d, :, :]: strided rows
        "add_digit_views": (ak.ADD, (dig[:, 0], dig[:, 2], q), {}),
        # the conv pack: [C, 1, N] on limb 0
        "add_pack": (ak.ADD, (pk, pk2, q[:1]), {}),
        "sub_rows": (ak.SUB, (a, b, q), {}),
        # ModRaise: e − q0 mod q_i, a column
        "sub_col": (ak.SUB, (a, _col(), q), {}),
        "sub_scalar_a": (ak.SUB, (_col(), b, q), {}),
        "sub_digit_views": (ak.SUB, (dig[1, 1], dig[0, 2], q), {}),
        "sub_sliced": (ak.SUB, (a[1::2], b[:3], q[1::2]), {}),
        "neg_rows": (ak.NEG, (a, q), {}),
        "neg_sliced": (ak.NEG, (bb[:, 2:5], q[2:5]), {}),
        # _sum_rows: each giant's inner sum over nb babies
        "sum_babies": (ak.SUM, (stack, q), {"dim": 0}),
        # _ks_core: the digit sum of [lead, beta, R, N]
        "sum_digits": (ak.SUM, (dig, q), {"dim": -3}),
        # a stack of row slices: terms 6·n apart, rows a slice of each
        "sum_sliced": (ak.SUM, (wide[1:6, 1:5], q[1:5]), {"dim": 0}),
        # the rescale: a top limb [1, N] against the lower limbs
        "centred_rescale": (ak.CENTRED, (a, _coeffs((1, n), 13), q, _col()),
                            {"half": half}),
        # a batch of ciphertexts [C, L, N] against their tops [C, 1, N]
        "centred_batch": (ak.CENTRED, (bb, _coeffs((3, 1, n), 14), q, _col()),
                          {"half": half}),
    }


def _plain(op, ops, **kw):
    """The plain version of one case."""
    if op == ak.ADD:
        return mm.add_mod_plain(*ops)
    if op == ak.SUB:
        return mm.sub_mod_plain(*ops)
    if op == ak.NEG:
        return mm.neg_mod_plain(*ops)
    if op == ak.SUM:
        return mm.sum_mod_plain(*ops, kw["dim"])
    a, b, q, c = ops
    return mm.centred_sub_plain(a, b, kw["half"], c, q)


def _kernel_view(op, ops, **kw):
    """The operands as the wrapper hands them to `plan` and the kernel: a
    sum's stack as its first term, the number of terms and their step."""
    if op != ak.SUM:
        return ops, 1, 0
    t, q = ops
    dim = kw["dim"] % t.dim()
    return (t.select(dim, 0), q), t.shape[dim], t.stride(dim)


def _plan(op, ops, **kw):
    kops, k, step = _kernel_view(op, ops, **kw)
    return ak.plan(*ak.describe(op, kops, k, step, kw.get("half", 0)))


def _flat(t):
    """The whole storage of t as a flat int64 tensor, and t's offset in it."""
    flat = torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())
    return flat, t.storage_offset()


def _apply(op, x, y, q, c, half):
    """csrc/mod_add.cu's per-element formulas in wrapped uint64."""
    def sub(u, v):
        d = u - v
        return np.where(u >= v, d, d + q)

    if op == ak.ADD:
        s = x + y
        return np.where(s >= q, s - q, s)
    if op == ak.SUB:
        return sub(x, y)
    if op == ak.NEG:
        return np.where(x == 0, np.uint64(0), q - x)
    return np.where(y > np.uint64(half), sub(x, c), x)


def _model_kernel(pl, op, ops, **kw):
    """csrc/mod_add.cu in numpy: returns (out, visits), both [rows·n]."""
    kops, _, _ = _kernel_view(op, ops, **kw)
    # the (a, b, q, c) slots; an operand the operation does not read is q
    if len(kops) == 2:
        ordered = [kops[0], kops[1], kops[1], kops[1]]
    else:
        ordered = list(kops) + [kops[2]] * (4 - len(kops))
    flats, bases = zip(*[_flat(t) for t in ordered])
    u64 = [f.numpy().view(np.uint64) for f in flats]
    gx, gy, gz = pl.grid
    L = pl.launch
    assert (L.gx, L.gy, L.gz) == pl.grid and L.op == op
    n, units, lanes = pl.n, (pl.n // 2 if pl.vec else pl.n), (2 if pl.vec else 1)
    out = np.zeros(pl.rows * n, dtype=np.uint64)
    visits = np.zeros(pl.rows * n, dtype=np.int64)
    tile = L.threads * ak.PER_THREAD
    for bz in range(gz):
        for by in range(gy):
            row = bz * gy + by
            if row >= L.rows:
                continue
            off = [0] * ak.N_OPS                     # thread 0 of the block
            r = row
            for d in range(ak.MAX_DIMS - 1, 0, -1):
                if d < L.nd:
                    hi = r // L.size[d]
                    lo = r - hi * L.size[d]
                    for i in range(ak.N_OPS):
                        off[i] += lo * L.stride[i][d]
                    r = hi
            for i in range(ak.N_OPS):
                off[i] += r * L.stride[i][0]
            if pl.vec:                               # 16-byte accesses are aligned
                for i, col in ((0, L.a_col), (1, L.b_col)):
                    if col:
                        assert (ordered[i].data_ptr() + 8 * off[i]) % 16 == 0
                if op == ak.SUM:
                    assert L.step % 2 == 0
            bx = np.arange(gx)[:, None, None]
            t = np.arange(L.threads)[None, :, None]
            i = np.arange(ak.PER_THREAD)[None, None, :]
            u = (bx * tile + t + i * L.threads).ravel()
            u = u[u < units]
            cols = (u[:, None] * lanes + np.arange(lanes)[None, :]).ravel()

            def read(slot, extra=0, col=True):
                at = bases[slot] + off[slot] + extra
                return u64[slot][at + cols] if col else \
                    np.full(cols.shape, u64[slot][at], dtype=np.uint64)

            qq = u64[2][bases[2] + off[2]]
            x = read(0, 0, L.a_col)
            if op == ak.SUM:
                for term in range(1, L.k):
                    y = read(0, term * L.step, L.a_col)
                    s = x + y
                    x = np.where(s >= qq, s - qq, s)
                res = x
            else:
                y = read(1, 0, L.b_col)
                cc = u64[3][bases[3] + off[3]]
                res = _apply(op, x, y, qq, cc, L.half)
            out[row * n + cols] = res
            np.add.at(visits, row * n + cols, 1)
    return torch.from_numpy(out.view(np.int64)), visits


@pytest.mark.parametrize("name", sorted(_cases()))
def test_model_kernel_visits_every_element_once(name):
    op, ops, kw = _cases()[name]
    pl = _plan(op, ops, **kw)
    assert not pl.collapse and pl.vec
    got, visits = _model_kernel(pl, op, ops, **kw)
    assert (visits == 1).all()
    want = _plain(op, ops, **kw)
    assert pl.shape == tuple(want.shape)
    assert torch.equal(got.reshape(pl.shape), want)


def test_merged_row_dims_of_the_call_patterns():
    n = N
    dims = {k: _plan(op, ops, **kw).dims for k, (op, ops, kw) in _cases().items()}
    assert dims["add_rows"] == ((6, (n, n, 1, 0)),)
    assert dims["add_col"] == ((6, (n, 1, 1, 0)),)
    assert dims["add_lead_bcast"] == ((3, (0, 6 * n, 0, 0)), (6, (n, n, 1, 0)))
    # [2, 3, 6, n] digit views: the lead dim keeps the digit stride
    assert dims["add_digit_views"] == ((2, (18 * n, 18 * n, 0, 0)),
                                       (6, (n, n, 1, 0)))
    assert dims["add_pack"] == ((3, (n, n, 0, 0)),)
    assert dims["sub_sliced"] == ((3, (2 * n, n, 2, 0)),)
    assert dims["neg_rows"] == ((6, (n, 0, 1, 0)),)
    assert dims["sum_babies"] == ((6, (n, 0, 1, 0)),)
    assert dims["sum_digits"] == ((2, (18 * n, 0, 0, 0)), (6, (n, 0, 1, 0)))
    assert dims["sum_sliced"] == ((4, (n, 0, 1, 0)),)
    assert dims["centred_rescale"] == ((6, (n, 0, 1, 1)),)
    assert dims["centred_batch"] == ((3, (6 * n, n, 0, 0)), (6, (n, 0, 1, 1)))
    pls = {k: _plan(op, ops, **kw) for k, (op, ops, kw) in _cases().items()}
    assert (pls["add_col"].a_col, pls["add_col"].b_col) == (1, 0)
    assert (pls["sub_scalar_a"].a_col, pls["sub_scalar_a"].b_col) == (0, 1)
    assert (pls["neg_rows"].a_col, pls["neg_rows"].b_col) == (1, 0)
    assert (pls["sum_digits"].k, pls["sum_digits"].step) == (3, 6 * n)
    assert (pls["sum_sliced"].k, pls["sum_sliced"].step) == (5, 6 * n)
    assert pls["centred_rescale"].launch.half == MODS[-1] // 2


def test_launch_structure_mirrors_the_plan():
    op, ops, kw = _cases()["sum_digits"]
    pl = _plan(op, ops, **kw)
    L = pl.launch
    assert (L.n, L.rows, L.nd, L.op) == (pl.n, pl.rows, len(pl.dims), ak.SUM)
    assert (L.k, L.step) == (pl.k, pl.step)
    assert [L.size[d] for d in range(L.nd)] == [s for s, _ in pl.dims]
    assert [[L.stride[i][d] for i in range(ak.N_OPS)] for d in range(L.nd)] \
        == [list(st) for _, st in pl.dims]
    assert (L.a_col, L.b_col, L.vec) == (1, 0, 1)
    assert L.threads == pl.threads == ak.THREADS
    assert L.gy * L.gz >= L.rows and L.gx * L.threads * ak.PER_THREAD >= L.n // 2
    assert ak.OPS.index("centred") == ak.CENTRED == 4


def test_vector_or_scalar_path_by_alignment_n_and_step():
    q = _q()
    a, b = _residues((6, N), 1), _residues((6, N), 2)
    assert _plan(ak.ADD, (a, b, q)).vec
    # a view offset by one element along the last axis: not 16-byte aligned
    wide = _residues((6, N + 2), 3)
    assert not _plan(ak.ADD, (wide[:, 1:N + 1], b, q)).vec
    assert not _plan(ak.SUB, (a, wide[:, 1:N + 1], q)).vec
    assert not _plan(ak.NEG, (wide[:, 1:N + 1], q)).vec
    # aligned start and even row stride: still the vector path
    assert _plan(ak.ADD, (wide[:, 2:N + 2], b, q)).vec
    # an odd row stride breaks alignment from the second row on
    odd = _residues((6, N + 1), 4)
    assert not _plan(ak.ADD, (odd[:, :N], b, q)).vec
    # a column scalar is read with one 8-byte load: its alignment is free
    assert _plan(ak.ADD, (a[1:], _col()[1:], q[1:])).vec
    # the centred form's threshold operand b is a row: it must align too
    top = _coeffs((1, N + 1), 5)
    assert not _plan(ak.CENTRED, (a, top[:, 1:], q, _col()), half=3).vec
    # a sum whose terms lie an odd number of elements apart
    st = _residues((4, 6, N + 1), 6)[..., :N]
    assert st.stride(0) % 2 == 0 and _plan(ak.SUM, (st, q), dim=0).vec is False
    flat = _residues((1, 5 * N + 1), 7).reshape(-1)[:5 * N]
    odd_step = flat.as_strided((4, 1, N), (N + 1, N, 1))
    pl = _plan(ak.SUM, (odd_step, q[:1]), dim=0)
    assert pl.step == N + 1 and not pl.vec
    got, visits = _model_kernel(pl, ak.SUM, (odd_step, q[:1]), dim=0)
    assert (visits == 1).all()
    assert torch.equal(got.reshape(pl.shape),
                       mm.sum_mod_plain(odd_step, q[:1], 0))
    # N = 2 is one vector a row; an odd N has none
    assert _plan(ak.ADD, (a[:, :2].contiguous(), b[:, :2].contiguous(), q)).vec
    a3, b3 = a[:, :3].contiguous(), b[:, :3].contiguous()
    pl = _plan(ak.SUB, (a3, b3, q))
    assert not pl.vec and pl.n == 3
    got, visits = _model_kernel(pl, ak.SUB, (a3, b3, q))
    assert (visits == 1).all()
    assert torch.equal(got.reshape(6, 3), mm.sub_mod_plain(a3, b3, q))


@pytest.mark.parametrize("op", ["add", "sub", "neg", "sum", "centred"])
@pytest.mark.parametrize("n", [1, 3, 1030])
def test_model_kernel_scalar_view_and_small_n(op, n):
    """The scalar path on a misaligned view, N = 1 and odd, and a ragged
    last tile, against the plain version, for every operation."""
    code = ak.OPS.index(op)
    q = _q()
    a = _residues((2, 6, n + 1), 5)[..., 1:]
    b = _residues((6, n), 6)
    ops = {ak.ADD: (a, b, q), ak.SUB: (b, a, q), ak.NEG: (a, q),
           ak.SUM: (a, q), ak.CENTRED: (a, _coeffs((1, n), 7), q, _col())}[code]
    kw = {ak.SUM: {"dim": 0}, ak.CENTRED: {"half": MODS[-1] // 2}}.get(code, {})
    pl = _plan(code, ops, **kw)
    assert not pl.vec
    got, visits = _model_kernel(pl, code, ops, **kw)
    assert (visits == 1).all()
    assert torch.equal(got.reshape(pl.shape), _plain(code, ops, **kw))


def test_plan_cache_keys_on_operation_shapes_strides_and_alignment():
    q = _q()
    a, b = _residues((6, N), 1), _residues((6, N), 2)
    p1 = _plan(ak.ADD, (a, b, q))
    assert _plan(ak.ADD, (a.clone(), b.clone(), q)) is p1
    assert _plan(ak.SUB, (a, b, q)) is not p1
    wide = _residues((6, N + 2), 3)
    assert _plan(ak.ADD, (wide[:, 1:N + 1], b, q)) is not \
        _plan(ak.ADD, (wide[:, 2:N + 2], b, q))
    top = _coeffs((1, N), 4)
    c = _col()
    assert _plan(ak.CENTRED, (a, top, q, c), half=5) is not \
        _plan(ak.CENTRED, (a, top, q, c), half=6)
    st = _residues((4, 6, N), 5)
    assert _plan(ak.SUM, (st, q), dim=0) is not _plan(ak.SUM, (st[:3], q), dim=0)


def test_tile_fills_the_card_at_the_main_shapes():
    """[29, N] at N = 65536 gives 128 blocks a row, and a one-row centred
    correction still 128 blocks."""
    n = 1 << 16
    lay = lambda *shapes: tuple((s, tuple(int(np.prod(s[i + 1:]))
                                          for i in range(len(s))))
                                for s in shapes)
    pl = ak.plan(ak.ADD, lay((29, n), (29, n), (29, 1)), (True, True))
    assert pl.vec and pl.grid == (128, 29, 1)
    one = ak.plan(ak.CENTRED, lay((1, n), (1, n), (1, 1), (1, 1)), (True, True),
                  half=7)
    assert one.vec and one.grid == (128, 1, 1)
    many = ak.plan(ak.NEG, lay((70000, 4), (1, 1)), (True, True))
    assert many.grid[1] * many.grid[2] >= 70000 and many.grid[1] <= 65535


def test_what_the_kernel_cannot_index_collapses():
    q = _q(2)
    a = _residues((2, 1, 2, 1, 2, 1, 2, N), 8)
    b = _residues((1, 2, 1, 2, 1, 2, 2, N), 9)
    pl = _plan(ak.ADD, (a, b, q))
    assert pl.collapse and len(pl.dims) > ak.MAX_DIMS
    shape = (2, 2, 2, 2, 2, 2, 2, N)
    full = [t.expand(shape).contiguous() for t in (a, b)]
    merged = _plan(ak.ADD, (*full, q))
    assert not merged.collapse and merged.dims == ((64, (2 * N, 2 * N, 0, 0)),
                                                   (2, (N, N, 1, 0)))
    # a row operand strided along the last axis is copied first too
    q6, b6 = _q(), _residues((6, N), 2)
    strided = _residues((6, 2 * N), 10)[:, ::2]
    assert _plan(ak.SUB, (strided, b6, q6)).collapse
    assert _plan(ak.CENTRED, (b6, strided[:1], q6, _col()), half=1).collapse
    assert not _plan(ak.SUB, (strided.contiguous(), b6, q6)).collapse


def test_plan_rejects_what_the_kernel_does_not_take():
    q = _q()
    a = _residues((6, N), 1)
    with pytest.raises(ValueError):
        _plan(ak.ADD, (a, a, a))                 # q varies along the row
    with pytest.raises(ValueError):
        _plan(ak.CENTRED, (a, a[:1], q, a), half=1)   # so does c
    with pytest.raises(ValueError):
        ak.plan(*ak.describe(ak.ADD, (a, q)))    # one operand short
    with pytest.raises(ValueError):
        ak.plan(*ak.describe(ak.SUM, (a, q), 0, 0))   # no terms
    for call in (lambda: ak.add_mod_cuda(a, a, q),     # CPU tensors
                 lambda: ak.neg_mod_cuda(a, q),
                 lambda: ak.sum_mod_cuda(a[None], q, 0)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        ak.sub_mod_cuda(a, a.to(torch.int32), q)
    with pytest.raises(TypeError):
        ak.centred_sub_cuda(a, a[:1], 1, q.to(torch.int32), q)


def test_formulas_in_exact_integers_near_2_62():
    """The kernel's wrapped uint64 formulas give the canonical residue for
    the largest moduli and the edge values 0, 1, q−1, q/2."""
    mods = boot_params(16).moduli
    for q in (max(mods), min(mods), MODS[0]):
        edge = np.array([0, 1, q // 2, q // 2 + 1, q - 2, q - 1],
                        dtype=np.uint64)
        x, y = (v.ravel() for v in np.meshgrid(edge, edge))
        qq = np.uint64(q)
        xi, yi = x.astype(object), y.astype(object)
        assert (_apply(ak.ADD, x, y, qq, 0, 0) == (xi + yi) % q).all()
        assert (_apply(ak.SUB, x, y, qq, 0, 0) == (xi - yi) % q).all()
        assert (_apply(ak.NEG, x, y, qq, 0, 0) == (-xi) % q).all()
        for c in (0, 1, q - 1):
            got = _apply(ak.CENTRED, x, y, qq, np.uint64(c), q // 2)
            want = np.where(yi > q // 2, (xi - c) % q, xi)
            assert (got == want).all()


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_sum_mod_plain_is_the_chained_add_in_every_order(k):
    """Canonical residues sum to the same residue in any order: the
    kernel's one pass, which adds in order, equals every chain."""
    q = _q()
    t = _residues((k, 6, N), 20 + k)
    t[..., 2] = (q - 1).T                    # k·(q−1): every addition wraps
    got = mm.sum_mod_plain(t, q, 0)
    for order in itertools.permutations(range(k)):
        acc = t[order[0]]
        for i in order[1:]:
            acc = mm.add_mod_plain(acc, t[i], q)
        assert torch.equal(got, acc)
    moved = t.movedim(0, 1)                  # the same stack along dim 1
    assert torch.equal(mm.sum_mod_plain(moved, q, 1), got)
    assert torch.equal(mm.sum_mod(moved, q, -2), got)


def test_centred_sub_plain_is_the_rescales_where_line():
    q = _q()
    red = _residues((3, 6, N), 30)
    top = _coeffs((3, 1, N), 31)
    c = _col()
    half = MODS[-1] // 2
    want = torch.where(top > half, mm.sub_mod_plain(red, c, q), red)
    assert torch.equal(mm.centred_sub_plain(red, top, half, c, q), want)
    assert torch.equal(mm.centred_sub(red, top, half, c, q), want)


def test_cpu_tensors_take_the_plain_versions_and_count_them():
    q = _q()
    a, b = _residues((6, N), 1), _residues((6, N), 2)
    before = ak.STATS.launches, ak.STATS.plain_calls
    assert torch.equal(mm.add_mod(a, b, q), mm.add_mod_plain(a, b, q))
    assert torch.equal(mm.sub_mod(a, b, q), mm.sub_mod_plain(a, b, q))
    assert torch.equal(mm.neg_mod(a, q), mm.neg_mod_plain(a, q))
    st = torch.stack([a, b, a])
    assert torch.equal(mm.sum_mod(st, q), mm.sum_mod_plain(st, q))
    assert ak.STATS.launches == before[0]
    # three forms twice each, and each 3-term sum two additions twice
    assert ak.STATS.plain_calls == before[1] + 3 * 2 + 2 * 2
    one = mm.sum_mod(st[:1], q)
    assert one.data_ptr() == st.data_ptr() and torch.equal(one, a)
