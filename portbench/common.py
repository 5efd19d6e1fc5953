"""What every part of the benchmark shares: the manifest and the files it
names, the frozen yardstick, the coefficient layout the models' features
live in, and the seeded draws of weights and inputs.

Nothing here imports the measured program."""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = 1 << 30


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The workload `name` with what the manifest and the benchmark's
    files say of it: → dict(workload, config, traffic, limits,
    end_to_end, per_layer), each metric list cut to those it reports."""
    bench = bench or manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]

    def mine(m):
        return name in m.get("workloads", [name])
    return dict(workload=w, config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def yardstick() -> dict:
    return load_json(HERE / "yardstick.json")


def int32_slots_per_s(ys: dict) -> float:
    """The H100's 32-bit integer issue rate: lanes x SMs x clock."""
    c = ys["int32_issue"]
    return c["lanes_per_sm"] * c["sms"] * c["clock_hz"]


def ntt_row_seconds(ys: dict, log_n: int, inverse: bool) -> float:
    """The least time the chip could take for one N-point NTT row: the
    larger of its bytes (the row read once and written once, and its
    twiddles read once: 16·N) at the HBM rate and its (N/2)·logN
    butterflies at the frozen issue slots a butterfly."""
    n = 1 << log_n
    slots = ys["slots_per_butterfly"]["inverse" if inverse else "forward"]
    t_bytes = ys["ntt_bytes_per_coefficient"] * n / ys["hbm_bytes_per_s"]
    t_ops = (n // 2) * log_n * slots / int32_slots_per_s(ys)
    return max(t_bytes, t_ops)


def modmul_per_s(ys: dict) -> float:
    """Peak 64-bit modular multiplications a second: the issue rate over
    the frozen slots of one Montgomery product."""
    return int32_slots_per_s(ys) / ys["slots_per_modmul"]


def ntt_group(ys: dict, kernel: str) -> bool:
    """Whether a device kernel's name is one of the NTT kernels."""
    return any(part in kernel for part in ys["ntt_kernel_names"])


def layout_index(n: int, in_wid: int, norm: int, raw: int, n_ch: int,
                 step: int = 1) -> np.ndarray:
    """Where a model keeps features [raw, raw, n_ch] among the N
    coefficients: pixel (i, j) at grid position (step·i + init,
    step·j + init) of an in_wid² grid with N/in_wid² channel slots a
    position, channel c at slot c·norm; init is 0 for an odd raw width,
    else step − 1 (the paper's multiplexed packing, test.go:140-148)."""
    mb = n // (in_wid * in_wid)
    init = 0 if raw % 2 == 1 else step - 1
    pos = step * np.arange(raw) + init
    return (pos[:, None, None] * in_wid * mb + pos[None, :, None] * mb
            + norm * np.arange(n_ch)[None, None, :])


def seed_words(seed: int, *tags: int) -> list[int]:
    """Entropy for numpy's SeedSequence from the run's seed and tags:
    any whole number, the seed split into 32-bit words."""
    seed = int(seed)
    if seed < 0:
        raise SystemExit("--seed must not be negative")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    return words + list(tags)


def draw_weights(shapes: list, cfg: dict, seed: int, device: str):
    """Seeded weights of a conv-BN stack and its FC head, drawn on
    `device` with one torch generator in two calls: kernels He-uniform
    (variance 2/(k²·C_in), unit gain through conv + ReLU), BN scale and
    shift uniform in the config's ranges, the FC weight from
    N(0, fc_gain²/C) and its bias from N(0, fc_b_std²).  shapes:
    (k, C_in, C_out) a layer.  → (layers [dict(ker, a, b)], fc_w, fc_b),
    float64 arrays."""
    import torch
    wc = cfg["weights"]
    n_ch, n_out = shapes[-1][2], cfg["fc_out"]
    sizes = [k * k * ci * co + 2 * co for k, ci, co in shapes]
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(seed_words(seed, 1))
                      .generate_state(2, np.uint64)[0]))
    u = torch.rand(sum(sizes), generator=g, device=device,
                   dtype=torch.float64).cpu().numpy()
    nrm = torch.randn(n_ch * n_out + n_out, generator=g, device=device,
                      dtype=torch.float64).cpu().numpy()
    layers, at = [], 0
    lo_a, hi_a = wc["bn_a"]
    lo_b, hi_b = wc["bn_b"]
    for (k, ci, co), size in zip(shapes, sizes):
        v = u[at: at + size]
        at += size
        ker = (2 * v[: k * k * ci * co] - 1) * math.sqrt(6 / (k * k * ci))
        a = lo_a + (hi_a - lo_a) * v[k * k * ci * co: k * k * ci * co + co]
        b = lo_b + (hi_b - lo_b) * v[k * k * ci * co + co:]
        layers.append(dict(ker=ker.reshape(k, k, ci, co), a=a, b=b))
    fc_w = (nrm[: n_ch * n_out].reshape(n_ch, n_out) * wc["fc_gain"]
            / math.sqrt(n_ch))
    fc_b = nrm[n_ch * n_out:] * wc["fc_b_std"]
    return layers, fc_w, fc_b


def uniform_input(shape: tuple, seed: int, index: int) -> np.ndarray:
    """Input `index` of the run: uniform in [-1, 1], from the seed."""
    rng = np.random.default_rng(seed_words(seed, 2, index))
    return rng.uniform(-1.0, 1.0, shape)


def modmul_work(counters: dict, log_n: int) -> int:
    """64-bit modular multiplications counted by the program's kernel
    counters: (N/2)·logN butterflies an NTT row on either route, N
    products a row of the Montgomery product kernel."""
    n = 1 << log_n
    ntt = sum(int(r) * c for k in ("ntt_fwd", "ntt_inv", "mxu_fwd", "mxu_inv")
              for r, c in counters.get(k, {}).items())
    mont = sum(int(r) * c for r, c in counters.get("mont_mul", {}).items())
    return ntt * (n // 2) * log_n + mont * n
