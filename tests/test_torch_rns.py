"""The port's basis extension against the JAX package (CPU).

Exact equality.  The correction count v = ⌊Σ f32(y_j)·f32(1/q_j)⌋ is
float32 in both packages; if a coefficient's v ever differs, the
result differs by a multiple of Q_digit there, and the failure message
says where and by which multiple (a different but valid representative,
not an arithmetic fault).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.params import boot_params as jboot

from optimal_conv_tpu_torch.ckks.params import DeviceTables, boot_params

CPU = torch.device("cpu")

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain():
    return jboot(12), DeviceTables(boot_params(12), CPU)


def _mismatch_report(got, want, dst_mods, big_q):
    """Which coefficients differ, and by which multiple u of Q (±1, ±2)."""
    bad = np.nonzero((got != want).any(axis=-2))
    lines = [f"{len(bad[0])} coefficient(s) differ"]
    for pos in list(zip(*bad))[:5]:
        g = got[pos[:-1] + (slice(None), pos[-1])].astype(object)
        w = want[pos[:-1] + (slice(None), pos[-1])].astype(object)
        mult = [u for u in (-2, -1, 1, 2)
                if all((int(x) - int(y) - u * big_q) % r == 0
                       for x, y, r in zip(g, w, dst_mods))]
        lines.append(f"  at {pos}: differs by {mult or 'no small multiple'}·Q")
    return "\n".join(lines)


def _digit_case(chain, level, seed):
    jp, tabs = chain
    rng = np.random.default_rng(seed)
    c = np.stack([rng.integers(0, q, 1 << 12, dtype=np.uint64)
                  for q in jp.q_moduli[: level + 1]])
    c[:, 0] = 0
    c[:, 1] = np.array(jp.q_moduli[: level + 1], dtype=np.uint64) - 1
    want = np.asarray(jp.digit_extender(level).extend_digits(jnp.asarray(c)))
    got = tabs.digit_extender(level).extend_digits(
        torch.from_numpy(c.view(np.int64))).numpy().view(np.uint64)
    return jp, got, want


# level 27: digits (5,5,5,5,5,3); 15: (5,5,5,1) and 5: (5,1), the ragged
# splits the ReLU's relinearisations start and end with; 0: one limb
@pytest.mark.parametrize("level", [27, 0, 15, 5])
def test_extend_digits_bit_exact(chain, level):
    jp, got, want = _digit_case(chain, level, level)
    assert got.shape == want.shape == (len(jp.digits(level)),
                                       len(jp.qp_idx(level)), 1 << 12)
    if not np.array_equal(got, want):
        dst = [jp.moduli[i] for i in jp.qp_idx(level)]
        for b, dig in enumerate(jp.digits(level)):
            big_q = int(np.prod([jp.moduli[i] for i in dig], dtype=object))
            if not np.array_equal(got[b], want[b]):
                pytest.fail(f"digit {b}: " + _mismatch_report(
                    got[b], want[b], dst, big_q))


def test_extend_p_to_q_bit_exact(chain):
    """The mod-down's P → Q_27 extension (5 source primes)."""
    jp, tabs = chain
    pidx, qidx = jp.p_idx(), jp.q_idx(27)
    rng = np.random.default_rng(5)
    x = np.stack([np.stack([rng.integers(0, jp.moduli[i], 1 << 12,
                                         dtype=np.uint64) for i in pidx])
                  for _ in range(2)])                    # [2, P, N]
    want = np.asarray(jp.extender(pidx, qidx).extend(jnp.asarray(x)))
    got = tabs.extender(pidx, qidx).extend(
        torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    assert got.shape == want.shape
    if not np.array_equal(got, want):
        pytest.fail(_mismatch_report(got, want, [jp.moduli[i] for i in qidx],
                                     jp.big_p))
