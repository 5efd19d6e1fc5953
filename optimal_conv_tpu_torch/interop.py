"""State exchange with the JAX package, as numpy arrays.

The port's counterpart of ``optimal_conv_tpu/utils/serialization.py``:
it reads secret keys, switching keys, ciphertexts and plaintexts that
the JAX package holds or saved, so both packages can compute on the same
state, and writes its own keys and ciphertexts in the JAX package's
archive format.  Residues cross as integer arrays (uint64 or int64;
every value is below 2^62) and become int64 tensors on the context's
device.  Nothing here imports JAX.
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from .ckks.context import CkksContext, SwitchingKey
from .ckks.types import Ciphertext, Plaintext
from .core.ntt import galois_perm_ntt


def to_tensor(a, device) -> torch.Tensor:
    """Residue array (uint64/int64, values < 2^62) → int64 tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype != np.int64:
        raise TypeError(f"residues must be uint64 or int64, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 residue tensor → uint64 numpy array (the JAX package's dtype)."""
    return t.detach().cpu().numpy().view(np.uint64)


def load_secret_key(ctx: CkksContext, sk_ints) -> None:
    """Install the JAX context's secret key (``ctx._sk_ints`` there)."""
    ctx.set_secret_key(np.asarray(sk_ints, dtype=np.int64))


KEY_TAGS = ("gal", "galh", "rlk")


def _install(ctx: CkksContext, key, d0, d1, seed: int | None,
             perm) -> None:
    """Check one key against the context's chain and put it into the key
    cache: `d1` stored, or None for a seed-compressed key (`seed` set; a
    "galh" key also carries `perm`, which must be the NTT-domain
    permutation of φ_g⁻¹)."""
    p = ctx.params
    tag, level = key[0], int(key[-1])
    if tag not in KEY_TAGS or len(key) != (2 if tag == "rlk" else 3):
        raise ValueError(f"unsupported key {key!r}")
    shape = (len(p.digits(level)), len(p.qp_idx(level)), p.n)
    if tuple(np.shape(d0)) != shape or (d1 is not None
                                        and tuple(np.shape(d1)) != shape):
        raise ValueError(f"key {key}: expected {shape}, got "
                         f"{np.shape(d0)} / {np.shape(d1)}")
    mine = (tag, level) if tag == "rlk" else \
        (tag, int(key[1]) % (2 * p.n), level)
    perm_t = None
    if tag == "galh":
        perm_t = ctx.galois_perm(pow(mine[1], -1, 2 * p.n))
        if perm is not None and not np.array_equal(np.asarray(perm),
                                                   perm_t.cpu().numpy()):
            raise ValueError(f"key {key}: its permutation is not φ_g⁻¹'s")
    if d1 is None and (seed is None or seed < 0):
        raise ValueError(f"key {key}: neither d1 nor a seed")
    ctx._swk_cache.put(mine, SwitchingKey(
        to_tensor(d0, ctx.device),
        None if d1 is None else to_tensor(d1, ctx.device), level,
        seed=None if seed is None or seed < 0 else int(seed), perm=perm_t))


def load_switching_keys(ctx: CkksContext, keys: dict) -> int:
    """keys: {tag: (d0, d1)} with d0/d1 [beta, l+1+P, N] NTT + Montgomery,
    as the JAX package's ``swk.d0`` and ``swk_d1(swk)``.  The tags are the
    JAX key cache's: ``("gal", g, level)`` (``galois_key``),
    ``("galh", g, level)`` (``galois_key_hoisted``, both halves already
    permuted by φ_g⁻¹) and ``("rlk", level)`` (``relin_key``).  Each key
    goes into the context's key cache, under its budgets.  Returns the
    number of keys installed."""
    for key, (d0, d1) in keys.items():
        _install(ctx, key, d0, d1, None, None)
    return len(keys)


def load_keys(path: str, ctx: CkksContext) -> int:
    """Read a JAX ``save_keys`` archive (``serialization.py:60-78``): its
    secret key and its relinearisation, Galois and pre-permuted hoisting
    keys (the archive marks the last in column 4 of its index; their
    stored halves are the permuted ones).  A key with d1 stored loads
    whole; a seed-compressed one (column 3 "False") loads as d0, its seed
    and, for "galh", its permutation, and the context regenerates d1 as
    the JAX package does.  Returns the number of keys loaded."""
    z = np.load(path, allow_pickle=True)
    load_secret_key(ctx, z["sk"])
    index = z["index"]
    for i, row in enumerate(index):
        key = ast.literal_eval(row[0])
        permuted = len(row) > 4 and row[4] == "True"
        if permuted != (key[0] == "galh"):
            raise ValueError(f"key {key}: permuted flag {permuted} does not "
                             "match its tag")
        stored = row[3] == "True"
        _install(ctx, key, z[f"d0_{i}"], z[f"d1_{i}"] if stored else None,
                 int(row[2]), z[f"perm_{i}"] if permuted else None)
    return len(index)


def save_keys(path: str, ctx: CkksContext) -> None:
    """Write the secret key and every switching key of the context in
    the JAX ``save_keys`` format (``serialization.py:37-60``): ``d0_i``,
    for a pre-permuted hoisting key ("galh") ``perm_i``, its NTT-domain
    permutation by φ_g⁻¹, and one index row a key, (repr(tag), level,
    seed, d1 stored, permuted).  A seed-compressed key is written as the
    JAX package writes one: its seed and no ``d1_i`` (the JAX package
    regenerates the same d1 from it).  A key with d1 stored is written
    whole, with seed -1.  Memos are never written."""
    p = ctx.params
    blobs = {"sk": ctx._sk_ints}
    index = []
    for i, (tag, swk) in enumerate(ctx.switching_keys.items()):
        blobs[f"d0_{i}"] = to_numpy(swk.d0)
        stored = swk.d1 is not None
        if stored:
            blobs[f"d1_{i}"] = to_numpy(swk.d1)
        permuted = tag[0] == "galh"
        if permuted:
            blobs[f"perm_{i}"] = galois_perm_ntt(p.log_n,
                                                 pow(tag[1], -1, 2 * p.n))
        seed = "-1" if stored else str(swk.seed)
        index.append((repr(tag), str(swk.level), seed, str(stored),
                      str(permuted)))
    blobs["index"] = np.array(index, dtype=object)
    np.savez_compressed(path, **blobs)


def save_ciphertext(path: str, ct: Ciphertext) -> None:
    """Write the JAX ``save_ciphertext`` format (``serialization.py:25-27``):
    c0, c1 as uint64 residues, level, scale, is_ntt (always: the port
    keeps every ciphertext in the NTT domain)."""
    np.savez_compressed(path, c0=to_numpy(ct.c0), c1=to_numpy(ct.c1),
                        level=ct.level, scale=ct.scale, is_ntt=True)


def ciphertext_from_arrays(ctx: CkksContext, c0, c1, level: int,
                           scale: float) -> Ciphertext:
    """An NTT-domain ciphertext from its two residue arrays."""
    return Ciphertext(to_tensor(c0, ctx.device), to_tensor(c1, ctx.device),
                      level=int(level), scale=float(scale))


def load_ciphertext(ctx: CkksContext, path: str) -> Ciphertext:
    """Read a JAX ``save_ciphertext`` archive (NTT domain only: the
    port keeps every ciphertext there)."""
    z = np.load(path)
    if not bool(z["is_ntt"]):
        raise ValueError(f"{path}: coefficient-domain ciphertexts are not "
                         "supported")
    return ciphertext_from_arrays(ctx, z["c0"], z["c1"], int(z["level"]),
                                  float(z["scale"]))


def plaintext_from_arrays(ctx: CkksContext, poly, level: int, scale: float,
                          is_mont: bool = True) -> Plaintext:
    """An NTT-domain plaintext from its residue array."""
    return Plaintext(to_tensor(poly, ctx.device), level=int(level),
                     scale=float(scale), is_mont=is_mont)
