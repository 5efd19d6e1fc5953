"""The launch plan of the CUDA Montgomery product (K1), on the CPU.

``csrc/mont_mul.cu`` cannot run without a card, but which element each
thread reads and writes is integer arithmetic that a CPU can repeat.
``mont_kernel.plan`` is a pure function of the operands' shapes, strides
and 16-byte alignment, so it is tested here on CPU tensors, and
``_model_kernel`` below re-enacts the kernel's block → row → offsets and
thread → column arithmetic in numpy: driven by a plan it must write
every output element exactly once and pair the elements that
``torch.broadcast_tensors`` pairs.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.params import boot_params
from optimal_conv_tpu_torch.core import modmath as mm
from optimal_conv_tpu_torch.core import mont_kernel as mk
from optimal_conv_tpu_torch.core import rowgeom

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


def _tables(k=6):
    return mm.limb_tables(MODS[:k], "cpu")


def _cases(n=N):
    """The call patterns of the port: name → (a, b, q, qinv, c or None)."""
    q, qinv, r2, _ = _tables()
    a = _residues((6, n), 1)
    b = _residues((6, n), 2)
    bb = _residues((3, 6, n), 3)
    a2 = torch.stack([a, a.flip(-1)])[:, None]                 # [2, 1, 6, n]
    bs = torch.stack([b[:, :1] % q[i] for i in range(3)])      # [3, 6, 1]
    y = _residues((5, 4, n), 4)                                # [B, K, n]
    qhat = r2[:3]                                              # [R, 1]
    return {
        "same": (a, b, q, qinv, None),
        "row_scalar": (a, r2, q, qinv, None),
        "scalar_a": (r2, b, q, qinv, None),
        "lead_bcast": (a[None], bb, q, qinv, None),
        "mid_bcast": (a2, bs, q[:3, None], qinv[:3, None], None),
        "sliced": (a[1::2], b[:3], q[1::2], qinv[1::2], None),
        # ops/conv.py: one ciphertext half × C plaintexts × SetScale constant
        "conv_chain": (a[None, :2], bb[:, :2], q[:2], qinv[:2], r2[:2]),
        # core/rns.py extend: y[..., j:j+1, :] × qhat_mont[j]
        "rns_extend": (y[..., 1:2, :], qhat, q[:3], qinv[:3], None),
    }


def _plan(a, b, q, qinv, c):
    return mk.plan(*mk.describe(a, b, q, qinv, c))


def _flat(t):
    """The whole storage of t as a flat int64 tensor, and t's offset in it."""
    flat = torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())
    return flat, t.storage_offset()


def _model_kernel(pl, a, b, q, qinv, c):
    """csrc/mont_mul.cu in numpy: returns (out, visits), both [rows·n]."""
    gx, gy, gz = pl.grid
    n, units, lanes = pl.n, (pl.n // 2 if pl.vec else pl.n), (2 if pl.vec else 1)
    ops = [a, b, q, qinv, q if c is None else c]
    flats, bases = zip(*[_flat(t) for t in ops])
    out = torch.zeros(pl.rows * n, dtype=torch.int64)
    visits = np.zeros(pl.rows * n, dtype=np.int64)
    L = pl.launch
    assert (L.gx, L.gy, L.gz) == pl.grid
    tile = L.threads * mk.PER_THREAD
    for bz in range(gz):
        for by in range(gy):
            row = bz * gy + by
            if row >= L.rows:
                continue
            off = [0] * mk.N_OPS                     # thread 0 of the block
            r = row
            for d in range(mk.MAX_DIMS - 1, 0, -1):
                if d < L.nd:
                    hi = r // L.size[d]
                    lo = r - hi * L.size[d]
                    for k in range(mk.N_OPS):
                        off[k] += lo * L.stride[k][d]
                    r = hi
            for k in range(mk.N_OPS):
                off[k] += r * L.stride[k][0]
            if pl.vec:                               # 16-byte accesses are aligned
                for k, col in ((0, L.a_col), (1, L.b_col)):
                    if col:
                        assert (ops[k].data_ptr() + 8 * off[k]) % 16 == 0
            bx = np.arange(gx)[:, None, None]
            t = np.arange(L.threads)[None, :, None]
            i = np.arange(mk.PER_THREAD)[None, None, :]
            u = (bx * tile + t + i * L.threads).ravel()
            u = u[u < units]
            cols = (u[:, None] * lanes + np.arange(lanes)[None, :]).ravel()
            ci = torch.from_numpy(cols)
            x = flats[0][bases[0] + off[0] + (ci if L.a_col else 0)]
            y = flats[1][bases[1] + off[1] + (ci if L.b_col else 0)]
            qq = flats[2][bases[2] + off[2]]
            qi = flats[3][bases[3] + off[3]]
            res = mm.mont_mul_plain(x, y, qq, qi)
            if L.chained:
                res = mm.mont_mul_plain(res, flats[4][bases[4] + off[4]], qq, qi)
            out[row * n + ci] = res
            np.add.at(visits, row * n + cols, 1)
    return out, visits


@pytest.mark.parametrize("name", sorted(_cases()))
def test_model_kernel_visits_every_element_once(name):
    a, b, q, qinv, c = _cases()[name]
    pl = _plan(a, b, q, qinv, c)
    assert not pl.collapse
    got, visits = _model_kernel(pl, a, b, q, qinv, c)
    assert (visits == 1).all()
    want = (mm.mont_mul_plain(a, b, q, qinv) if c is None else
            mm.mont_mul2_plain(a, b, c, q, qinv))
    assert pl.shape == tuple(want.shape)
    assert torch.equal(got.reshape(pl.shape), want)


def test_merged_row_dims_of_the_call_patterns():
    n = N
    dims = {k: _plan(*v).dims for k, v in _cases().items()}
    assert dims["same"] == ((6, (n, n, 1, 1, 0)),)
    assert dims["row_scalar"] == ((6, (n, 1, 1, 1, 0)),)
    assert dims["scalar_a"] == ((6, (1, n, 1, 1, 0)),)
    assert dims["lead_bcast"] == ((3, (0, 6 * n, 0, 0, 0)),
                                  (6, (n, n, 1, 1, 0)))
    assert dims["mid_bcast"] == ((2, (6 * n, 0, 0, 0, 0)),
                                 (3, (0, 6, 1, 1, 0)),
                                 (6, (n, 1, 0, 0, 0)))
    assert dims["sliced"] == ((3, (2 * n, n, 2, 2, 0)),)
    assert dims["conv_chain"] == ((3, (0, 6 * n, 0, 0, 0)),
                                  (2, (n, n, 1, 1, 1)))
    assert dims["rns_extend"] == ((5, (4 * n, 0, 0, 0, 0)),
                                  (3, (0, 1, 1, 1, 0)))
    cols = {k: (_plan(*v).a_col, _plan(*v).b_col) for k, v in _cases().items()}
    assert cols["same"] == (1, 1) and cols["row_scalar"] == (1, 0)
    assert cols["scalar_a"] == (0, 1) and cols["rns_extend"] == (1, 0)
    assert _plan(*_cases()["conv_chain"]).chained
    assert not _plan(*_cases()["same"]).chained


def test_launch_structure_mirrors_the_plan():
    pl = _plan(*_cases()["conv_chain"])
    L = pl.launch
    assert (L.n, L.rows, L.nd) == (pl.n, pl.rows, len(pl.dims))
    assert [L.size[d] for d in range(L.nd)] == [s for s, _ in pl.dims]
    assert [[L.stride[k][d] for k in range(mk.N_OPS)] for d in range(L.nd)] \
        == [list(st) for _, st in pl.dims]
    assert (L.a_col, L.b_col, L.chained, L.vec) == (1, 1, 1, 1)
    assert L.threads == pl.threads == mk.THREADS
    assert L.gy * L.gz >= L.rows and L.gx * L.threads * mk.PER_THREAD >= L.n // 2


def test_vector_or_scalar_path_by_alignment_and_n():
    q, qinv, r2, _ = _tables()
    a, b = _residues((6, N), 1), _residues((6, N), 2)
    assert _plan(a, b, q, qinv, None).vec
    # a view offset by one element along the last axis: not 16-byte aligned
    wide = _residues((6, N + 2), 3)
    assert not _plan(wide[:, 1:N + 1], b, q, qinv, None).vec
    assert not _plan(a, wide[:, 1:N + 1], q, qinv, None).vec
    # aligned start and even row stride: still the vector path
    assert _plan(wide[:, 2:N + 2], b, q, qinv, None).vec
    # an odd row stride breaks alignment from the second row on
    odd = _residues((6, N + 1), 4)
    assert not _plan(odd[:, :N], b, q, qinv, None).vec
    # a column scalar is read with one 8-byte load: its alignment is free
    assert _plan(a[1:], r2[1:], q[1:], qinv[1:], None).vec
    # N = 2 is one vector a row; an odd N has none
    assert _plan(a[:, :2].contiguous(), b[:, :2].contiguous(), q, qinv, None).vec
    a3, b3 = a[:, :3].contiguous(), b[:, :3].contiguous()
    pl = _plan(a3, b3, q, qinv, None)
    assert not pl.vec and pl.n == 3
    got, visits = _model_kernel(pl, a3, b3, q, qinv, None)
    assert (visits == 1).all()
    assert torch.equal(got.reshape(6, 3), mm.mont_mul_plain(a3, b3, q, qinv))


@pytest.mark.parametrize("n", [1, 2, 3, 1030])
def test_model_kernel_scalar_view_and_small_n(n):
    """The scalar path on a misaligned view, N = 1, 2 and odd, and a ragged
    last tile, against the plain version."""
    q, qinv, r2, _ = _tables()
    wide = _residues((2, 6, n + 1), 5)
    a = wide[..., 1:]
    b = _residues((6, n), 6)
    pl = _plan(a, b, q, qinv, r2)
    assert not pl.vec or n == 1
    got, visits = _model_kernel(pl, a, b, q, qinv, r2)
    assert (visits == 1).all()
    assert torch.equal(got.reshape(pl.shape),
                       mm.mont_mul2_plain(a, b, r2, q, qinv))


def test_plan_cache_keys_on_shapes_strides_and_alignment():
    q, qinv, _, _ = _tables()
    a, b = _residues((6, N), 1), _residues((6, N), 2)
    p1 = _plan(a, b, q, qinv, None)
    assert _plan(a.clone(), b.clone(), q, qinv, None) is p1
    stepped = torch.cat([a, b])[::2]
    p2 = _plan(stepped, b, q, qinv, None)
    assert p2 is not p1 and p2.dims == ((6, (2 * N, N, 1, 1, 0)),)
    wide = _residues((6, N + 2), 3)
    assert _plan(wide[:, 1:N + 1], b, q, qinv, None) is not \
        _plan(wide[:, 2:N + 2], b, q, qinv, None)


def test_tile_fills_the_card_at_every_row_count():
    """[1,N] and [2,N] at N = 65536 still give about one block, or two,
    for each of the H100's 132 SMs."""
    n = 1 << 16
    lay = lambda *shapes: tuple((s, tuple(int(np.prod(s[i + 1:]))
                                          for i in range(len(s))))
                                for s in shapes)
    for rows in (1, 2):
        pl = mk.plan(lay((rows, n), (rows, 1), (rows, 1), (rows, 1)),
                     (True, True))
        gx, gy, gz = pl.grid
        assert pl.vec and gx * gy * gz == 128 * rows
    big = mk.plan(lay((1, 2, n), (256, 2, n), (2, 1), (2, 1), (2, 1)),
                  (True, True))
    assert big.grid == (n // 2 // (mk.THREADS * mk.PER_THREAD), 512, 1)
    many = mk.plan(lay((70000, 4), (70000, 4), (1, 1), (1, 1)), (True, True))
    assert many.grid[1] * many.grid[2] >= 70000 and many.grid[1] <= 65535


def test_more_row_dims_than_the_kernel_indexes_collapse():
    q, qinv, _, _ = _tables(2)
    a = _residues((2, 1, 2, 1, 2, 1, 2, N), 8)
    b = _residues((1, 2, 1, 2, 1, 2, 2, N), 9)
    pl = _plan(a, b, q, qinv, None)
    assert pl.collapse and len(pl.dims) > mk.MAX_DIMS
    shape = (2, 2, 2, 2, 2, 2, 2, N)
    full = [t.expand(shape).contiguous() for t in (a, b)]
    # materialised, the operands merge into at most the limb dim and the rest
    merged = _plan(*full, q, qinv, None)
    assert not merged.collapse and merged.dims == ((64, (2 * N, 2 * N, 0, 0, 0)),
                                                   (2, (N, N, 1, 1, 0)))
    # the wrapper's rowgeom.materialise expands q and qinv too: one row dim
    again = _plan(*rowgeom.materialise(pl.shape, (a, b, q, qinv)), None)
    assert not again.collapse and again.dims == ((128, (N, N, 1, 1, 0)),)


def test_strided_last_axis_is_copied_alone_or_collapses():
    """The plan cannot index a row operand strided along the last axis:
    it collapses, as the additive kernel's does.  The wrapper first copies
    that operand alone (``rowgeom.rows_contiguous``), the broadcast
    operands staying in place."""
    q, qinv, r2, _ = _tables()
    b = _residues((6, N), 2)
    strided = _residues((6, 2 * N), 10)[:, ::2]
    assert _plan(strided, b, q, qinv, None).collapse
    assert _plan(b, strided, q, qinv, r2).collapse
    b1 = b[:1]
    ops = rowgeom.rows_contiguous((strided, b1, q, qinv), 2)
    assert ops[0].is_contiguous() and torch.equal(ops[0], strided)
    assert all(x is y for x, y in zip(ops[1:], (b1, q, qinv)))
    pl = _plan(*ops, None)
    assert not pl.collapse and pl.vec
    assert pl.dims == ((6, (N, 0, 1, 1, 0)),)


def test_plan_rejects_what_the_kernel_does_not_take():
    q, qinv, _, _ = _tables()
    a = _residues((6, N), 1)
    with pytest.raises(ValueError):
        _plan(a, a, a, qinv, None)                 # q varies along the row
    with pytest.raises(ValueError):
        _plan(a, a, q, qinv, a)                    # c varies along the row
    with pytest.raises(ValueError):
        mk.mont_mul_cuda(a, a, q, qinv, q)         # CPU tensors never launch


def test_chained_product_stays_in_range_in_exact_integers():
    """The kernel leaves the first product lazily reduced (below 2q) and
    canonicalises once: for a < 4q, b, c < q both products stay inside
    mont_mul's input range and the result is the canonical residue of
    a·b·c·2^-128, which two canonical products give."""
    rng = np.random.default_rng(11)
    r = 1 << 64
    for q in MODS[:3] + boot_params(16).moduli[-2:]:
        qinv = mm.mont_qinv(q)
        rinv = pow(r, -1, q)
        edge = [0, 1, q - 1]
        for _ in range(200):
            a = int(rng.choice(edge + [4 * q - 1, int(rng.integers(0, 4 * q))]))
            b = int(rng.choice(edge + [int(rng.integers(0, q))]))
            c = int(rng.choice(edge + [int(rng.integers(0, q))]))

            def lazy(x, y):
                t = x * y
                lo, hi = t % r, t // r
                m = lo * qinv % r
                return hi + m * q // r + (lo != 0)

            t1 = lazy(a, b)
            assert t1 < 2 * q and t1 % q == a * b * rinv % q
            t2 = lazy(t1, c)
            assert t2 < 2 * q
            assert (t2 - q if t2 >= q else t2) == a * b * c * rinv * rinv % q


def test_mont_mul2_on_cpu_is_two_plain_products():
    q, qinv, r2, _ = _tables()
    a, b = _residues((6, N), 1), _residues((6, N), 2)
    before = mk.STATS.launches, mk.STATS.plain_calls
    got = mm.mont_mul2(a, b, r2, q, qinv)
    assert mk.STATS.launches == before[0]
    assert mk.STATS.plain_calls == before[1] + 2
    assert torch.equal(got, mm.mont_mul(mm.mont_mul(a, b, q, qinv), r2, q, qinv))
    assert torch.equal(mm.mul_mod(a, b, q, qinv, r2), got)


def _evaluator_cases(n=N):
    """The call patterns the evaluator adds: name → (a, b, q, qinv, c)."""
    q, qinv, r2, _ = _tables()
    a = _residues((6, n), 11)
    b = _residues((6, n), 12)
    dig = _residues((3, 6, n), 13)                             # [beta, R, n]
    key = _residues((3, 6, n), 14)
    x = _residues((3, 2, n), 15)                               # [beta, alpha, n]
    col = torch.stack([r2[:2, 0], r2[2:4, 0], r2[4:6, 0]])[..., None]
    sq = torch.stack([q[:2, 0], q[2:4, 0], q[4:6, 0]])[..., None]
    sqi = torch.stack([qinv[:2, 0], qinv[2:4, 0], qinv[4:6, 0]])[..., None]
    return {
        # mul_ct: two standard-form operands, r2 chained (modmath.mul_mod)
        "mul_ct_chain": (a, b, q, qinv, r2),
        # the same after drop_level: row slices of taller tensors
        "mul_ct_chain_dropped": (a[:4], b[:4], q[:4], qinv[:4], r2[:4]),
        # _ks_core: every digit against its own key rows, nothing broadcast
        "key_inner": (dig, key, q, qinv, None),
        # extend_digits: per-digit, per-limb constants [beta, alpha, 1]
        "digit_scale": (x, col, sq, sqi, None),
        # mul_scalar_int / _hoist_identity: a [L, 1] constant column
        "const_col": (a, r2, q, qinv, None),
    }


@pytest.mark.parametrize("name", sorted(_evaluator_cases()))
def test_evaluator_call_patterns(name):
    """The kernel model at the shapes mul_ct, the key inner product and
    the ragged digit split hand to K1: every element once, equal to the
    plain version, on the 16-byte path, with no materialised operand."""
    a, b, q, qinv, c = _evaluator_cases()[name]
    pl = _plan(a, b, q, qinv, c)
    assert pl.vec and not pl.collapse and pl.chained == (c is not None)
    got, visits = _model_kernel(pl, a, b, q, qinv, c)
    assert (visits == 1).all()
    want = (mm.mont_mul_plain(a, b, q, qinv) if c is None else
            mm.mont_mul2_plain(a, b, c, q, qinv))
    assert torch.equal(got.reshape(pl.shape), want)
    if name == "key_inner":
        n = N
        assert pl.dims == ((3, (6 * n, 6 * n, 0, 0, 0)), (6, (n, n, 1, 1, 0)))
    if name == "mul_ct_chain":
        assert pl.dims == ((6, (N, N, 1, 1, 1)),)
