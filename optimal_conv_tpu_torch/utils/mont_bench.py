"""K1 (the Montgomery product) and the additive kernel on the card, at the
main path's shapes.

    python -m optimal_conv_tpu_torch.utils.mont_bench [--ab]

Needs one CUDA device.  Prints the card's name and power limit, the
whole-kernel SASS counts of ``csrc/mont_mul.cu``, then for each timed
shape (the conv's at 16²×256, a level-15 ct × ct product's and the
bootstrap transforms' at levels 27, 3 and 2) the
kernel's time beside the time its bytes need at 3.35 TB/s (each distinct
input byte read once, each output byte written once),
and the wrapper's host microseconds per call at [2, N].  Then the
additive kernel of ``csrc/mod_add.cu`` beside the PyTorch chain it
replaced (``modmath``'s plain versions, on the card) at [29, N] add,
[2, 33, N] sub of strided digit views and a 16-term sum: each one's card
ms with the L2 flushed before each call (back to back beside it, which
the host's enqueue can bound) against the bytes bound, and the host µs a
call of both at [29, N].
``chip_smoke.py`` times the same cases.  With ``--ab`` it also times them,
and [1, N], under block sizes of 256, 128 and 64 threads, each four times
(two passes down the list and back up), in this one process on this one
card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from ..ckks.params import boot_params
from ..core import modmath as mm
from ..core import mont_kernel
from . import kernel_info
from .timing import cuda_ms, cuda_ms_cold

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


def residues(mods, lead, n, rng, dev) -> torch.Tensor:
    """Uniform residues [*lead, L, n] with 0 and q-1 in every row."""
    a = np.stack([rng.integers(0, q, size=tuple(lead) + (n,), dtype=np.int64)
                  for q in mods], axis=-2)
    a[..., 0] = 0
    a[..., 1] = np.array(mods, dtype=np.int64) - 1
    return torch.from_numpy(a).to(dev)


def timed_cases(p, rng, dev) -> list[dict]:
    """The shapes K1 is timed at, all from the conv at 16²×256 (conv 3 3):
    the ct × 256 plaintext product, the same with the SetScale constant
    chained, the key inner product of the first pack stage, a per-limb
    constant against 256 rows (rescale, mod-down) and the Montgomery
    fold of one kernel plaintext.  `cold` cases are timed with the L2
    flushed, as their callers find it."""
    n = p.n
    qs = p.q_moduli
    q2, qi2, r2_2, _ = mm.limb_tables(qs[:2], dev)
    qp = [p.moduli[i] for i in p.qp_idx(0)]
    q6, qi6, _, _ = mm.limb_tables(qp, dev)
    q1, qi1, r2_1, _ = mm.limb_tables(qs[:1], dev)
    ct = residues(qs[:2], (1,), n, rng, dev)
    pls = residues(qs[:2], (256,), n, rng, dev)
    dig = residues(qp, (128, 1), n, rng, dev)
    key = residues(qp, (1,), n, rng, dev)
    rows = residues(qs[:1], (256,), n, rng, dev)
    pt = residues(qs[:2], (), n, rng, dev)
    return [
        dict(shape="[1,2,65536] x [256,2,65536]", args=(ct, pls, q2, qi2),
             c=None, cold=False),
        dict(shape="[1,2,65536] x [256,2,65536] x [2,1] chained",
             args=(ct, pls, q2, qi2), c=r2_2, cold=False),
        dict(shape="[128,1,6,65536] x [1,6,65536]", args=(dig, key, q6, qi6),
             c=None, cold=False),
        dict(shape="[256,1,65536] x [1,1]", args=(rows, r2_1, q1, qi1),
             c=None, cold=False),
        dict(shape="[2,65536] x [2,1]", args=(pt, r2_2, q2, qi2), c=None,
             cold=True),
    ]


def evaluator_cases(p, rng, dev) -> list[dict]:
    """K1's shapes in a ct × ct product at level 15 of the fork's chain,
    where the ReLU starts: the chained product of two standard-form
    [16,N] operands with r2 (``modmath.mul_mod``) and the key inner
    product of the four key-switch digits on the 21 limbs of Q_15·P,
    nothing broadcast.  The first is 25 MB and shorter than the host's
    time to enqueue it, so it is timed call by call with the L2 flushed."""
    n = p.n
    qs = p.q_moduli[:16]
    q16, qi16, r2_16, _ = mm.limb_tables(qs, dev)
    qp = [p.moduli[i] for i in p.qp_idx(15)]
    q21, qi21, _, _ = mm.limb_tables(qp, dev)
    a = residues(qs, (), n, rng, dev)
    b = residues(qs, (), n, rng, dev)
    dig = residues(qp, (4,), n, rng, dev)
    key = residues(qp, (4,), n, rng, dev)
    return [
        dict(shape="[16,65536] x [16,65536] x [16,1] chained",
             args=(a, b, q16, qi16), c=r2_16, cold=True),
        dict(shape="[4,21,65536] x [4,21,65536]", args=(dig, key, q21, qi21),
             c=None, cold=False),
    ]


def bootstrap_cases(p, rng, dev, nb: int = 8) -> list[dict]:
    """K1's shapes in the bootstrap's BSGS transforms on the fork's chain:
    at level 27 (the first CtoS transform) and at the StoC levels 3 and 2,
    one giant's inner products with its `nb` babies on Q_level·P (the
    double-hoisted form) and on Q_level, and the key inner product of the
    level's key-switch digits.  Nothing is broadcast.  The cases under
    40 MB are timed with the L2 flushed."""
    n = p.n
    cases = []
    for level in (27, 3, 2):
        beta = len(p.digits(level))
        qp = [p.moduli[i] for i in p.qp_idx(level)]
        qs = p.q_moduli[: level + 1]
        tq, tqi, _, _ = mm.limb_tables(qp, dev)
        sq, sqi, _, _ = mm.limb_tables(qs, dev)
        for mods, lead, q, qi, what in (
                (qp, nb, tq, tqi, "inner product on QP"),
                (qs, nb, sq, sqi, "inner product on Q"),
                (qp, beta, tq, tqi, "key inner product")):
            a = residues(mods, (lead,), n, rng, dev)
            b = residues(mods, (lead,), n, rng, dev)
            shape = f"[{lead},{len(mods)},{n}]"
            cases.append(dict(shape=f"{shape} x {shape}", args=(a, b, q, qi),
                              c=None, cold=a.numel() * 8 < 40e6,
                              what=f"{what}, level {level}"))
    return cases


def run_case(case) -> torch.Tensor:
    """The product of one timed case through the port's entry points."""
    a, b, q, qinv = case["args"]
    if case["c"] is None:
        return mm.mont_mul(a, b, q, qinv)
    return mm.mont_mul2(a, b, case["c"], q, qinv)


def case_bytes(case) -> int:
    """Distinct input bytes once plus output bytes once."""
    ins = list(case["args"]) + ([] if case["c"] is None else [case["c"]])
    out = torch.broadcast_shapes(*[t.shape for t in ins])
    return 8 * (sum(t.numel() for t in ins) + int(np.prod(out)))


def time_case(case, dev) -> dict:
    """Device ms of one case: `ms` as its callers find the L2 (flushed
    for the cold cases), `warm_l2_ms` back to back."""
    warm = cuda_ms(lambda: run_case(case), dev, iters=50, warmup=5)
    ms = warm
    if case["cold"]:
        ms = cuda_ms_cold(lambda: run_case(case), dev, iters=30, warmup=20)
    return dict(ms=ms, warm_l2_ms=warm)


def host_us_per_call(fn, dev, calls: int = 1000, batch: int = 10) -> float:
    """Host microseconds of one call of fn(): the wall time of `calls`
    calls over `calls`, enqueued `batch` at a time on an idle card (a
    synchronise between batches, outside the timed region), so the host
    never waits for a full launch queue however long the device work."""
    for _ in range(20):
        fn()
    dt = 0.0
    for _ in range(calls // batch):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        dt += time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return dt / (calls // batch * batch) * 1e6


# the block sizes timed by --ab, each of mont_kernel.PER_THREAD units a thread
AB_THREADS = (256, 128, 64)


def tile_ab(cases, dev, passes: int = 2) -> None:
    """Times `cases` under each block size of AB_THREADS by overriding
    the plan's module-level choice: `passes` times down the list and
    back up.  Cold cases are timed with the L2 flushed."""
    keep = mont_kernel.THREADS
    times: dict = {}
    try:
        for threads in (AB_THREADS + AB_THREADS[::-1]) * passes:
            mont_kernel.THREADS = threads
            mont_kernel.plan.cache_clear()
            for case in cases:
                times.setdefault((threads, case["shape"]), []).append(
                    time_case(case, dev)["ms"])
    finally:
        mont_kernel.THREADS = keep
        mont_kernel.plan.cache_clear()
    for (threads, shape), ms in times.items():
        print(f"A/B tile {threads}x{mont_kernel.PER_THREAD} {shape}: "
              + " / ".join(f"{t:.4f}" for t in ms) + " ms")


def mod_add_cases(p, rng, dev) -> list[dict]:
    """The additive kernel's timed shapes, each with the kernel's call and
    the PyTorch chain it replaced (the plain version on the card), and
    the bytes one pass needs: the add of two [29, N] polynomials, the sub
    of two digit views t0[:, d] of a [2, 3, 33, N] key-switch product
    (strided rows) and one giant's inner sum over 16 babies of [8, N]."""
    n = p.n
    m29, m33 = p.moduli[:29], p.moduli[:33]
    q29 = mm.limb_tables(m29, dev)[0]
    q33 = mm.limb_tables(m33, dev)[0]
    a = residues(m29, (), n, rng, dev)
    b = residues(m29, (), n, rng, dev)
    t0 = residues(m33, (2, 3), n, rng, dev)
    st = residues(m29[:8], (16,), n, rng, dev)
    return [
        dict(shape="[29,65536] add", kernel=lambda: mm.add_mod(a, b, q29),
             chain=lambda: mm.add_mod_plain(a, b, q29), bytes=3 * a.numel() * 8),
        dict(shape="[2,33,65536] sub of digit views",
             kernel=lambda: mm.sub_mod(t0[:, 0], t0[:, 2], q33),
             chain=lambda: mm.sub_mod_plain(t0[:, 0], t0[:, 2], q33),
             bytes=3 * t0[:, 0].numel() * 8),
        dict(shape="[16,8,65536] sum over 16 terms",
             kernel=lambda: mm.sum_mod(st, q29[:8]),
             chain=lambda: mm.sum_mod_plain(st, q29[:8]),
             bytes=(16 + 1) * st[0].numel() * 8),
    ]


def small_cases(p, rng, dev) -> list[dict]:
    """The two row counts that leave the card short of blocks: [2,N] and
    [1,N] against a per-row constant, L2 flushed."""
    two = timed_cases(p, rng, dev)[-1]
    pt, r2, q, qi = two["args"]
    one = dict(shape="[1,65536] x [1,1]", args=(pt[:1], r2[:1], q[:1], qi[:1]),
               c=None, cold=True)
    return [two, one]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: K1 is timed on a GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for key, k in kernel_info.mont_kernel_instructions().items():
        print(f"mont_mul_kernel {key}: {k}")
    p = boot_params(16)
    rng = np.random.default_rng(2024)
    for case in (timed_cases(p, rng, dev) + evaluator_cases(p, rng, dev)
                 + bootstrap_cases(p, rng, dev)):
        t = time_case(case, dev)
        print(f"K1 {case['shape']}: {t['ms']:.4f} ms"
              f"{' (cold L2; warm %.4f)' % t['warm_l2_ms'] if case['cold'] else ''}"
              f", bytes bound {case_bytes(case) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    small = timed_cases(p, rng, dev)[-1]
    print(f"wrapper host time at {small['shape']}: "
          f"{host_us_per_call(lambda: run_case(small), dev):.2f} us per call")
    adds = mod_add_cases(p, rng, dev)
    for case in adds:
        bound = case["bytes"] / HBM_BYTES_PER_S * 1e3
        ms = {k: (cuda_ms_cold(case[k], dev, iters=30, warmup=5),
                  cuda_ms(case[k], dev, iters=50, warmup=5))
              for k in ("kernel", "chain")}
        print(f"mod_add {case['shape']}: " + ", ".join(
            f"{k} {c:.4f} ms (cold L2; back to back {w:.4f})"
            for k, (c, w) in ms.items()) + f", bytes bound {bound:.4f} ms")
    us = {"kernel": [], "chain": []}
    for k in ("chain", "kernel", "kernel", "chain"):
        us[k].append(host_us_per_call(adds[0][k], dev))
    print(f"host time at {adds[0]['shape']}: " + ", ".join(
        f"{k} " + " / ".join(f"{u:.2f}" for u in us[k]) for k in us)
        + " us per call")
    if "--ab" in argv:
        tile_ab(timed_cases(p, rng, dev)[:4] + small_cases(p, rng, dev), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
