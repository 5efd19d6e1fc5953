"""The port's prior-art baseline (``ops/baseline.py``) and the CLI's
baseline-first order against the JAX package (CPU).

Each homomorphic function runs on one ciphertext the port encrypts,
handed to JAX as numpy arrays; JAX then runs on the switching keys the
port made, put into its key cache under the same tags, and must give the
same residues.  The
geometry is the smallest that reaches every branch of the SISO conv: a
pad, a spatial tap that is zero for every channel, out-channel offsets
with and without a rotation, and the BN bias.  The bootstrap around the
baseline's ReLU is replaced by a recorder on both sides, so the fold and
the unfold are compared alone; the real bootstrap + ReLU runs port only,
to the JAX test's bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu import cli as jcli
from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.context import SwitchingKey as JaxKey
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.ckks.types import Ciphertext as JaxCiphertext
from optimal_conv_tpu.ops import baseline as jbl
from optimal_conv_tpu.ops import relu as jrelu

from optimal_conv_tpu_torch import cli, interop
from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams, mini_boot_params
from optimal_conv_tpu_torch.ops import baseline as bl
from optimal_conv_tpu_torch.ops.conv import conv2d_same_np
from optimal_conv_tpu_torch.ops.relu import relu_np

CPU = torch.device("cpu")
SEED = 23
# the chain of tests/test_ops_baseline.py less a level, on the logN-10 ring
CHAIN = dict(log_n=10, logq=(50, 40), logp=(55,), log_scale=30, h=64)
# 16² blocks: two channel blocks in the 512 slots, so one out-channel
# offset is rotated and one is not
IN_WID, KER_WID, CH, PAD = 16, 3, 2, 1
RAW = IN_WID - PAD

torch.set_num_threads(1)


class Pair:
    """The JAX and the port context on one secret key, and the bridge."""

    def __init__(self):
        self.j = JaxContext(JaxParams(**CHAIN), seed=SEED)
        self.t = CkksContext(CkksParams(**CHAIN), CPU, seed=SEED)

    def encrypt(self, slots, level=1):
        """(port ct, the same ct as a JAX ciphertext).  Every test works at
        level 1, so JAX traces each op once for all of them."""
        p = self.t.params
        ct = self.t.encrypt(self.t.encoder.encode_slots(slots, p.scale, level))
        return ct, self.to_jax(ct)

    @staticmethod
    def to_jax(ct):
        return JaxCiphertext(jnp.asarray(interop.to_numpy(ct.c0)),
                             jnp.asarray(interop.to_numpy(ct.c1)),
                             level=ct.level, scale=ct.scale)

    def share_keys(self) -> int:
        """Hand the port's switching keys to the JAX context's key cache
        under the same tags, so JAX makes none (its key generation is most
        of what these tests would cost): → the number JAX holds."""
        for tag, k in self.t.switching_keys.items():
            if self.j._swk_cache.get(tag) is None:
                self.j._swk_cache.put(tag, JaxKey(
                    jnp.asarray(interop.to_numpy(k.d0)),
                    jnp.asarray(interop.to_numpy(k.d1)), k.level))
        return len(self.j._swk_cache.d)

    def run(self, jax_fn, port_fn):
        """The port first (it makes the keys), then JAX on the same keys:
        (port outputs, JAX outputs), after a check that JAX made no key."""
        got = port_fn()
        held = self.share_keys()
        want = jax_fn()
        assert len(self.j._swk_cache.d) == held, "JAX made a key"
        return got, want


def _same_ct(got, want):
    assert (got.level, got.scale) == (want.level, want.scale)
    assert np.array_equal(interop.to_numpy(got.c0), np.asarray(want.c0))
    assert np.array_equal(interop.to_numpy(got.c1), np.asarray(want.c1))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _conv_data(seed=55):
    """Image, kernel (one spatial tap zero for every channel), BN."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (RAW, RAW, CH))
    ker = rng.uniform(-1, 1, (KER_WID, KER_WID, CH, CH)) / 4
    ker[0, 2] = 0.0
    return img, ker, rng.uniform(0.8, 1.2, CH), rng.uniform(-0.3, 0.3, CH)


def _padded_slots(img):
    padded = np.zeros((IN_WID, IN_WID, img.shape[-1]))
    padded[:RAW, :RAW] = img
    return bl.reshape_input_bl(padded.ravel(), IN_WID)


# ---------------------------------------------------------------------------
# the numpy helpers
# ---------------------------------------------------------------------------

def test_layout_helpers_equal_jax():
    """reshape_input_bl, reshape_ker_bl (with an overload norm),
    post_trim_bl and post_process_bl."""
    rng = np.random.default_rng(1)
    raw = rng.uniform(-1, 1, IN_WID * IN_WID * CH)
    assert np.array_equal(bl.reshape_input_bl(raw, IN_WID),
                          jbl.reshape_input_bl(raw, IN_WID))
    ker = rng.uniform(-1, 1, KER_WID * KER_WID * CH * 2)
    bn_a = rng.uniform(0.8, 1.2, 2)
    for norm in (1, 2):
        assert np.array_equal(
            bl.reshape_ker_bl(ker, bn_a, KER_WID, CH, 2, 16, norm),
            jbl.reshape_ker_bl(ker, bn_a, KER_WID, CH, 2, 16, norm))
    vals = rng.uniform(-1, 1, 512) + 1j * rng.uniform(-1, 1, 512)
    trim = bl.post_trim_bl(vals, RAW, IN_WID)
    assert np.array_equal(trim, jbl.post_trim_bl(vals, RAW, IN_WID))
    assert np.array_equal(bl.post_process_bl(trim, RAW),
                          jbl.post_process_bl(trim, RAW))


# ---------------------------------------------------------------------------
# the homomorphic functions, bit for bit
# ---------------------------------------------------------------------------

def test_eval_conv_bn_bl_bit_exact(pair):
    """k² hoisted rotations, the masked tap products (one tap all-zero and
    skipped), the out-channel rotate-sum and the bias; decrypted, the
    numpy conv + BN to 2e-3."""
    img, ker, bn_a, bn_b = _conv_data()
    tct, jct = pair.encrypt(_padded_slots(img))
    args = (ker.ravel(), bn_a, bn_b, IN_WID, KER_WID, CH, CH, PAD)
    got, want = pair.run(lambda: jbl.eval_conv_bn_bl(pair.j, jct, *args),
                         lambda: bl.eval_conv_bn_bl(pair.t, tct, *args))
    _same_ct(got, want)
    z = pair.t.decrypt_decode_slots(pair.t.rescale(got)).real
    out = bl.post_process_bl(bl.post_trim_bl(z[: IN_WID * IN_WID * CH], RAW,
                                             IN_WID), RAW)
    np.testing.assert_allclose(
        out, (conv2d_same_np(img, ker) * bn_a + bn_b).ravel(), atol=2e-3)


def test_conv_bl_split_bit_exact(pair):
    """The 2-ct × 2×2 block conv of the CLI: each output half sums a conv
    from each input half; the second has a zero bias."""
    img, ker, bn_a, bn_b = _conv_data(56)
    hb = CH // 2
    cts = [pair.encrypt(_padded_slots(img[..., h * hb:(h + 1) * hb]))
           for h in range(2)]
    args = (ker.ravel(), bn_a, bn_b, IN_WID, KER_WID, CH, PAD)
    got, want = pair.run(
        lambda: jbl.conv_bl_split(pair.j, cts[0][1], cts[1][1], *args),
        lambda: bl.conv_bl_split(pair.t, cts[0][0], cts[1][0], *args))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same_ct(g, w)
    halves = [pair.t.decrypt_decode_slots(pair.t.rescale(g)).real for g in got]
    out = np.concatenate([bl.post_trim_bl(h[: IN_WID * IN_WID * hb], RAW,
                                          IN_WID) for h in halves])
    np.testing.assert_allclose(
        bl.post_process_bl(out, RAW),
        (conv2d_same_np(img, ker) * bn_a + bn_b).ravel(), atol=2e-3)


def test_eval_rmfc_bl_bit_exact(pair):
    """Rotate-sum reduce-mean and the diagonal-method FC with its bias."""
    ch, out_num, spatial = 2, 2, 16
    p = pair.t.params
    blk = p.slots // ch
    rng = np.random.default_rng(57)
    feat = rng.uniform(-1, 1, (ch, spatial))
    fc_w = rng.uniform(-1, 1, (ch, out_num))
    fc_b = rng.uniform(-1, 1, out_num)
    slots = np.zeros(p.slots)
    for b in range(ch):
        slots[b * blk: b * blk + spatial] = feat[b]
    tct, jct = pair.encrypt(slots)
    got, want = pair.run(
        lambda: jbl.eval_rmfc_bl(pair.j, jct, fc_w, fc_b, ch, spatial),
        lambda: bl.eval_rmfc_bl(pair.t, tct, fc_w, fc_b, ch, spatial))
    _same_ct(got, want)
    z = pair.t.decrypt_decode_slots(pair.t.rescale(got)).real
    np.testing.assert_allclose(z[np.arange(out_num) * blk],
                               feat.mean(axis=1) @ fc_w + fc_b, atol=2e-3)


def test_eval_rmfc_bl_img_bit_exact(pair):
    """The ImageNet tail's reduce-mean + FC over 64-slot channel blocks."""
    in_batch, out_num, raw = 2, 2, 4
    p = pair.t.params
    rng = np.random.default_rng(58)
    feat = np.zeros((in_batch, 64))
    feat[:, : raw * raw] = rng.uniform(-1, 1, (in_batch, raw * raw))
    ker_fc = rng.uniform(-1, 1, in_batch * out_num)
    slots = np.zeros(p.slots)
    slots[: in_batch * 64] = feat.ravel()
    tct, jct = pair.encrypt(slots)
    args = (ker_fc, in_batch, out_num, raw)
    got, want = pair.run(lambda: jbl.eval_rmfc_bl_img(pair.j, jct, *args),
                         lambda: bl.eval_rmfc_bl_img(pair.t, tct, *args))
    _same_ct(got, want)


class _Btp:
    """Stands in for the baseline's bootstrapper: records what ctos gets
    and what stoc gets, and stoc returns a given ciphertext."""

    def __init__(self, delta0, boot):
        self.delta0 = delta0
        self.boot = boot
        self.seen = []

    def ctos(self, ct):
        self.seen.append(ct)
        return ct, None

    def stoc(self, up, low):
        self.seen.append(low)
        return self.boot


def test_fold_and_unfold_bit_exact(pair, monkeypatch):
    """eval_conv_bl_boot_relu with recorders for the bootstrap's halves
    and for eval_relu on both sides: the folded ciphertext (conjugate
    folds, ×i, set_scale to Δ0/2^(pow+2), declared Δ0, dropped to level
    0), the unfolded pair the ReLU gets and the ×2^pow outputs."""
    p = pair.t.params
    rng = np.random.default_rng(59)
    z1, z2, zb = (rng.uniform(-1, 1, p.slots) for _ in range(3))
    t1, j1 = pair.encrypt(z1)
    t2, j2 = pair.encrypt(z2)
    tb, jb = pair.encrypt(zb + 1j * rng.uniform(-1, 1, p.slots))
    delta0 = float(2 ** (round(np.log2(p.q_moduli[0])) - 8))
    jbtp, tbtp = _Btp(delta0, jb), _Btp(delta0, tb)
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jrelu), ("port", bl)):
        monkeypatch.setattr(mod, "eval_relu",
                            lambda ctx, ct, alpha, key=key:
                            seen[key].append(ct) or ct)
    got, want = pair.run(
        lambda: jbl.eval_conv_bl_boot_relu(pair.j, jbtp, j1, j2, 0.0, 4.0),
        lambda: bl.eval_conv_bl_boot_relu(pair.t, tbtp, t1, t2, 0.0, 4.0,
                                          shift=4.0 + 2))
    folded = tbtp.seen[0]
    assert (folded.level, folded.scale) == (0, delta0)
    _same_ct(folded, jbtp.seen[0])
    assert tbtp.seen[1] is None and jbtp.seen[1] is None
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for g, w in zip(seen["port"] + list(got), seen["jax"] + list(want)):
        _same_ct(g, w)
    # the fold's payload: 2(z1 + i·z2)/2^(pow+2) at Δ0
    fz = pair.t.decrypt_decode_slots(folded)
    np.testing.assert_allclose(fz, (z1 + 1j * z2) / 32, atol=1e-3)


class _Identity(_Btp):
    """A perfect bootstrap: what ctos got, decrypted and encrypted anew at
    level 1 and the chain's scale, as a bootstrap refreshes its input."""

    def __init__(self, delta0, ctx):
        super().__init__(delta0, None)
        self.ctx = ctx

    def stoc(self, up, low):
        ctx = self.ctx
        v = ctx.decrypt_decode_slots(up)
        return ctx.encrypt(ctx.encoder.encode_slots(v, ctx.params.scale, 1))


@pytest.mark.parametrize("shift", [6.0, 0.0])
def test_fold_shift_reaches_the_relu_as_z_over_2_pow(pair, monkeypatch, shift):
    """Whatever the shift of the packed values before the bootstrap, the
    ReLU gets z1/2^pow and z2/2^pow at the chain's scale (port only, a
    perfect bootstrap)."""
    p = pair.t.params
    rng = np.random.default_rng(60)
    z1, z2 = (rng.uniform(-1, 1, p.slots) for _ in range(2))
    seen = []
    monkeypatch.setattr(bl, "eval_relu",
                        lambda ctx, ct, alpha: seen.append(ct) or ct)
    delta0 = float(2 ** (round(np.log2(p.q_moduli[0])) - 8))
    bl.eval_conv_bl_boot_relu(pair.t, _Identity(delta0, pair.t),
                              pair.encrypt(z1)[0], pair.encrypt(z2)[0], 0.0,
                              4.0, shift=shift)
    for ct, z in zip(seen, (z1, z2)):
        assert ct.scale == p.scale
        np.testing.assert_allclose(pair.t.decrypt_decode_slots(ct).real,
                                   z / 16, atol=1e-3)


@pytest.mark.slow_e2e
@pytest.mark.parametrize("shift", [4.0 + 2, 0.0])
def test_boot_relu_at_decrypt_level(shift):
    """The real baseline boot + ReLU on mini_boot_params(9), port only:
    two slot ciphertexts in [-8, 8] share ONE bootstrap with StoC just
    under EvalMod, then the minimax ReLU; the JAX test's bar at pow 4,
    at the JAX package's shift and at the CLI's.  About 15-23 s a case
    on the CPU: over what the new tests can spend in tier 1, so it runs
    with OPTCONV_SLOW=1 (the card runs the same function at logN 16 in
    ``chip_smoke.py``)."""
    p = mini_boot_params(9, n_relu=14)
    ctx = CkksContext(p, CPU, seed=31)
    btp = SplitBootstrapper(ctx, log_sparse=0, k_range=12.0, sin_deg=31,
                            double_angle=3,
                            stoc_level=p.boot_layout["relu"][1] - 1)
    rng = np.random.default_rng(61)
    z1 = rng.uniform(-8, 8, p.slots)
    z2 = rng.uniform(-8, 8, p.slots)
    c1 = ctx.encrypt(ctx.encoder.encode_slots(z1, p.scale, p.max_level))
    c2 = ctx.encrypt(ctx.encoder.encode_slots(z2, p.scale, p.max_level))
    r1, r2 = bl.eval_conv_bl_boot_relu(ctx, btp, c1, c2, 0.0, 4.0,
                                       shift=shift)
    for r, z in ((r1, z1), (r2, z2)):
        err = np.abs(ctx.decrypt_decode_slots(r).real - relu_np(z)).max()
        assert err < 0.4, err


# ---------------------------------------------------------------------------
# the CLI: the baseline first, as the JAX CLI
# ---------------------------------------------------------------------------

def _order(monkeypatch, capsys, module, argv):
    calls = []
    monkeypatch.setattr(module, "run_conv_bl",
                        lambda ker, ib, n, *a, boot=False: calls.append(
                            ("bl", ker, ib, n, boot)))
    monkeypatch.setattr(module, "run_conv",
                        lambda ker, ib, n, *a, boot=False, debug=False:
                        calls.append(("ours", ker, ib, n, boot, debug)))
    assert module.main(list(argv)) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.endswith("start.")]
    return lines, calls


@pytest.mark.parametrize("argv", [["conv", "3", "0", "1"],
                                  ["convReLU", "5", "2", "3", "--debug"],
                                  ["conv", "3", "1", "2", "--no-bl"],
                                  ["convReLU", "3", "0", "1", "--no-bl"]])
def test_cli_runs_the_baseline_first(monkeypatch, capsys, argv):
    """``conv``/``convReLU`` print "Base Line start." and run the baseline,
    then "Ours start." and the paper's method, on the same arguments, as
    the JAX CLI does; ``--no-bl`` skips the baseline."""
    want = _order(monkeypatch, capsys, jcli, argv)
    got = _order(monkeypatch, capsys, cli, argv + ["--device", "cpu"])
    assert got == want
    lines, calls = got
    skip = "--no-bl" in argv
    assert lines == ([] if skip else ["Base Line start."]) + ["Ours start."]
    assert [c[0] for c in calls] == ([] if skip else ["bl"]) + ["ours"]
    assert not hasattr(cli, "MISSING")


def test_baseline_chains():
    """The baseline's chains: ``convReLU`` bootstraps on the Go fork's
    DefaultBootstrapParams[7] (the paper's chain above level 15; the ReLU's
    eleven 30-bit primes under three 60-bit StoC primes), ``conv`` runs on
    a chain whose level-1 prime is near the scale.  Each encrypts where the
    rescale after the tap products keeps the scale, one level above what
    the fold's set_scale needs."""
    from optimal_conv_tpu_torch.ckks.params import boot_params

    ours, paper = cli.bl_params(True), boot_params(16)
    assert ours.q_moduli[16:] == paper.q_moduli[16:]
    assert ours.p_moduli == paper.p_moduli and ours.max_level == 27
    bits = [round(np.log2(q)) for q in ours.q_moduli]
    lay = ours.boot_layout
    assert bits[lay["relu"][0]: lay["relu"][1]] == [30] * 11
    assert bits[lay["stoc"][0]: lay["stoc"][1]] == [60] * 3
    assert lay["stoc"][1] == lay["evalmod"][0]
    for boot in (False, True):
        p = cli.bl_params(boot)
        level = cli.bl_level(p)
        assert level >= 1 and abs(np.log2(p.q_moduli[level]) - 30) < 1
    assert cli.bl_level(ours) == 12 and cli.bl_level(cli.bl_params(False)) == 1
