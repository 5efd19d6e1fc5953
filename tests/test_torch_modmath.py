"""The port's modular arithmetic against the JAX package (CPU).

Exact equality for every modulus of boot_params(16) (28 Q + 5 P),
including the inputs 0 and q−1: both packages compute canonical
residues of the same exact operations.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_conv_tpu.ckks.params as jp
from optimal_conv_tpu.ckks.params import boot_params as jboot
from optimal_conv_tpu.core import modmath as jmm
from optimal_conv_tpu.core import pallas_mod as pm

from optimal_conv_tpu_torch.ckks import params as tparams
from optimal_conv_tpu_torch.core import modmath as mm
from optimal_conv_tpu_torch.core import mont_kernel

MODS = jboot(16).moduli
N = 2048

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = np.stack([rng.integers(0, q, N, dtype=np.uint64) for q in MODS])
    b = np.stack([rng.integers(0, q, N, dtype=np.uint64) for q in MODS])
    qs = np.array(MODS, dtype=np.uint64)
    a[:, :3] = [0, 0, 1]
    a[:, 3:6] = (qs - 1)[:, None]
    b[:, :3] = np.stack([np.zeros_like(qs), qs - 1, qs - 1], axis=1)
    b[:, 3:6] = np.stack([np.zeros_like(qs), qs - 1, np.ones_like(qs)], axis=1)
    return a, b


def _t(x):
    return torch.from_numpy(np.array(x, copy=True).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def test_host_helpers_equal():
    assert tparams.boot_params(16).moduli == MODS
    for log_n, sizes in ((10, [60, 45, 30, 55, 61]), (12, [50, 40, 40, 55])):
        assert mm.gen_ntt_primes(log_n, sizes) == jmm.gen_ntt_primes(log_n, sizes)
    for q in MODS[::4] + MODS[-2:]:
        assert mm.mont_qinv(q) == jmm.mont_qinv(q)
        assert mm.mont_r2(q) == jmm.mont_r2(q)
        assert mm.root_of_unity(q, 1 << 13) == jmm.root_of_unity(q, 1 << 13)
    c = np.random.default_rng(3).integers(-2**40, 2**40, 64)
    res = mm.centered_to_residues(c, MODS[:3])
    np.testing.assert_array_equal(res.view(np.uint64),
                                  jmm.centered_to_residues(c, MODS[:3]))
    back = mm.residues_to_centered(res, MODS[:3])
    np.testing.assert_array_equal(back, jmm.residues_to_centered(
        jmm.centered_to_residues(c, MODS[:3]), MODS[:3]))
    np.testing.assert_array_equal(back.astype(np.int64), c)


def test_ref_params_json_is_a_copy():
    jfile = os.path.join(os.path.dirname(jp.__file__), "ref_bootstrap_params.json")
    assert filecmp.cmp(jfile, tparams.REF_PARAMS_JSON, shallow=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_ops_bit_exact_all_moduli(seed):
    a, b = _operands(seed)
    q = np.array(MODS, dtype=np.uint64)[:, None]
    qi = np.array([jmm.mont_qinv(x) for x in MODS], dtype=np.uint64)[:, None]
    r2 = np.array([jmm.mont_r2(x) for x in MODS], dtype=np.uint64)[:, None]
    J = jnp.asarray
    tq, tqi, tr2, _ = mm.limb_tables(MODS, "cpu")
    assert np.array_equal(_u(tqi), qi) and np.array_equal(_u(tr2), r2)
    cases = {
        "mont_mul": (mm.mont_mul(_t(a), _t(b), tq, tqi),
                     jmm.mont_mul(J(a), J(b), J(q), J(qi))),
        "add_mod": (mm.add_mod(_t(a), _t(b), tq), jmm.add_mod(J(a), J(b), J(q))),
        "sub_mod": (mm.sub_mod(_t(a), _t(b), tq), jmm.sub_mod(J(a), J(b), J(q))),
        "neg_mod": (mm.neg_mod(_t(a), tq), jmm.neg_mod(J(a), J(q))),
        "mul_mod": (mm.mul_mod(_t(a), _t(b), tq, tqi, tr2),
                    jmm.mul_mod(J(a), J(b), J(q), J(qi), J(r2))),
        "to_mont": (mm.to_mont(_t(a), tq, tqi, tr2),
                    jmm.to_mont(J(a), J(q), J(qi), J(r2))),
        "from_mont": (mm.from_mont(_t(a), tq, tqi),
                      jmm.from_mont(J(a), J(q), J(qi))),
    }
    for name, (got, want) in cases.items():
        np.testing.assert_array_equal(_u(got), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_mont_mul2_bit_exact_all_moduli(seed):
    """The chained product's plain version equals the JAX package's
    mont_mul applied twice, on every modulus of boot_params(12), with 0
    and q-1 among a, b and the per-limb constant c."""
    mods = jboot(12).moduli
    assert tparams.boot_params(12).moduli == mods
    rng = np.random.default_rng(100 + seed)
    qs = np.array(mods, dtype=np.uint64)
    a = np.stack([rng.integers(0, q, N, dtype=np.uint64) for q in mods])
    b = np.stack([rng.integers(0, q, (3, N), dtype=np.uint64) for q in mods],
                 axis=1)                                          # [3, L, N]
    a[:, :3] = [0, 0, 1]
    a[:, 3:6] = (qs - 1)[:, None]
    b[..., :3] = np.stack([np.zeros_like(qs), qs - 1, qs - 1], axis=1)
    b[..., 3:6] = np.stack([np.zeros_like(qs), qs - 1, np.ones_like(qs)], axis=1)
    c = np.stack([rng.integers(0, q, 1, dtype=np.uint64) for q in mods])
    c[0], c[1] = 0, qs[1] - 1
    q = qs[:, None]
    qi = np.array([jmm.mont_qinv(x) for x in mods], dtype=np.uint64)[:, None]
    J = jnp.asarray
    tq, tqi, _, _ = mm.limb_tables(mods, "cpu")
    want = jmm.mont_mul(jmm.mont_mul(J(a)[None], J(b), J(q), J(qi)), J(c), J(q),
                        J(qi))
    for fn in (mm.mont_mul2_plain, mm.mont_mul2):
        got = fn(_t(a)[None], _t(b), _t(c), tq, tqi)
        np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_mont_mul_equals_pallas_kernel():
    """The plain mont_mul equals the TPU kernel (Pallas interpret mode),
    one modulus per bit size of the chain."""
    a, b = _operands(7)
    seen = set()
    for i, q in enumerate(MODS):
        if q.bit_length() in seen:
            continue
        seen.add(q.bit_length())
        qinv = jmm.mont_qinv(q)
        alo, ahi = pm.split64(a[i])
        blo, bhi = pm.split64(b[i])
        lo, hi = pm.mont_mul_pallas(jnp.asarray(alo), jnp.asarray(ahi),
                                    jnp.asarray(blo), jnp.asarray(bhi), q, qinv,
                                    interpret=True)
        want = pm.join64(np.asarray(lo), np.asarray(hi))
        got = mm.mont_mul(_t(a[i]), _t(b[i]),
                          torch.tensor(q), torch.tensor(mm.as_i64(qinv)))
        np.testing.assert_array_equal(_u(got), want, err_msg=f"q={q}")
    assert len(seen) >= 5


def test_cpu_tensor_takes_plain_path():
    """On CPU tensors mont_mul runs its plain version: the kernel's launch
    counter stays 0 and the plain counter moves."""
    tq, tqi, tr2, _ = mm.limb_tables(MODS[:2], "cpu")
    before = mont_kernel.STATS.launches, mont_kernel.STATS.plain_calls
    mm.mont_mul(torch.ones(2, 8, dtype=torch.int64), tr2, tq, tqi)
    assert mont_kernel.STATS.launches == before[0] == 0
    assert mont_kernel.STATS.plain_calls == before[1] + 1
    with pytest.raises(ValueError):
        mont_kernel.mont_mul_cuda(torch.ones(2, 8, dtype=torch.int64), tr2,
                                  tq, tqi)
