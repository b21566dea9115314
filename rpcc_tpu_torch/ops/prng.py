"""threefry2x32 in torch integer ops, bit-exact to ``jax.random``.

The encoder draws its RANSAC hypotheses and ground subsample from a
counter-based generator keyed by the frame seed.  Reproducing JAX's draws
bit for bit makes the port's bitstream comparable to the reference for the
same ``--seed``.  This follows jax 0.9's defaults: implementation
``threefry2x32`` with ``jax_threefry_partitionable=True`` (a draw of shape
S hashes the 64-bit flat counter ``i`` as the pair ``(i >> 32, i & mask)``
and returns ``bits1 ^ bits2``; ``split`` keeps both words).

A key is a ``(2,)`` int64 tensor holding two uint32 words; a batch of
keys is ``(B, 2)``, one per frame, and every draw then gets a leading B
whose row b equals the single-key draw of key b (``jax.vmap`` of the same
call).  uint32 arithmetic runs in int64 and is masked back to 32 bits
after every add, so it is exact on every device.  Nothing here holds
global state: keys are passed explicitly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from rpcc_tpu_torch.ops.const import upload

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def seed_words(seed, device) -> torch.Tensor:
    """Seeds as int64 words on ``device``: an int gives a 0-d tensor, a
    sequence or (B,) tensor of seeds a (B,) one.  Python seeds are
    range-checked on the host and go up without a wait (``const.upload``);
    a tensor is taken as it is (checking a device tensor would wait for the
    device)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64)
    vals = [int(s) for s in seed] if isinstance(seed, (list, tuple, range)) else int(seed)
    for s in vals if isinstance(vals, list) else [vals]:
        if not 0 <= s <= _MASK:
            raise ValueError(f"seed {s} is not a uint32")
    return upload(vals, torch.int64, device)


def prng_key(seed, device) -> torch.Tensor:
    """``jax.random.PRNGKey(np.uint32(seed))``: the words ``[0, seed]``.
    A sequence or (B,) tensor of seeds gives (B, 2) keys
    (:func:`seed_words`)."""
    seeds = seed_words(seed, device)
    return torch.stack([torch.zeros_like(seeds), seeds], -1)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x1, x2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash_counters(key: torch.Tensor, shape: Sequence[int]):
    """Hash the flat counters of a draw of ``shape`` under each key of
    ``key`` (..., 2) -> two (..., *shape) word tensors."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]  # (..., 1): broadcast over the counters
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & _MASK)
    lead = key.shape[:-1]
    return b1.reshape((*lead, *shape)), b2.reshape((*lead, *shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (..., num, 2) keys."""
    b1, b2 = _hash_counters(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, as int64 values in [0, 2^32)."""
    b1, b2 = _hash_counters(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1) from the top 23
    bits placed in the mantissa of a float in [1, 2)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32: two
    32-bit draws folded modulo the span (JAX's ``2 * nbits`` scheme)."""
    k = split(key)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(torch.int32)
