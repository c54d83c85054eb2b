"""Keyed temperature sampling: the reference's threefry stream in torch.

Counterpart of `sample_rows_keyed` in `repro/serve/engine.py`: row n is
sampled with the key `fold_in(fold_in(PRNGKey(seed), rid_n), step_n)` and
`jax.random.categorical(key, logits_n / temp)`, so a request's tokens
depend only on the seed, its id and the output index, never on its batch.
Everything here follows jax 0.9 (`jax/_src/prng.py`, `jax/_src/random.py`)
under its default `jax_threefry_partitionable=True` and 32-bit mode:

  threefry2x32   20 rounds of Threefry-2x32 with the key injected every
                 four rounds (`_threefry2x32_lowering`);
  prng_key       PRNGKey(seed) = (0, seed mod 2^32): the 32-bit seed's
                 high word is 0;
  fold_in        threefry2x32(key, (0, data)): the data's (hi, lo) words;
  random_bits    the 32-bit draw at flat index i is x0 ^ x1 of
                 threefry2x32(key, (i >> 32, i mod 2^32));
  uniform        f32 in [tiny, 1): (bits >> 9) | 0x3F800000 as f32, minus
                 1, scaled by (1 - tiny) == 1.0 in f32, plus tiny, clamped
                 below at tiny;
  gumbel         -log(-log(uniform)) ("low" mode);
  categorical    argmax(gumbel + logits / temp), the first index on ties.

uint32 words live in int64 tensors masked to 32 bits, so no sign bit can
leak through a shift or a rotation. The functions run on any device; on
the card the engine runs them inside its captured decode graphs, with the
key and the temperature as device tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import resolve

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


def as_u32(x) -> torch.Tensor:
    """Integer tensor -> its uint32 words in int64 (two's complement wrap:
    -1 is 0xFFFFFFFF, the padding rows' request id)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count words (x0, x1) under the key (k0, k1);
    all int64 holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`'s data: (2,) int64 uint32 words on
    `device`, the card unless the caller asks for the CPU (no card raises)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=resolve(device))


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`jax.random.fold_in` for a batch: key (..., 2), data (...) uint32
    words -> keys (..., 2)."""
    data = as_u32(data)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,))` for each key of a batch: key (..., 2)
    -> (..., n) uint32 words in int64."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32, i & MASK32)
    return b0 ^ b1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), minval=tiny)` per key, bitwise."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # (maxval - minval) = 1 - tiny rounds to 1.0 in f32: the scale is exact
    return torch.clamp_min(floats + _TINY, _TINY)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,))` per key, f32. The logs are torch's:
    within 2 ulp of XLA's, not bitwise (each library has its own)."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` per row: keys (N, 2), logits
    (N, V) f32 -> (N,) int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def sample_rows_keyed(key: torch.Tensor, rids, steps, logits: torch.Tensor,
                      temp) -> torch.Tensor:
    """Row n of logits (N, V) sampled at temperature `temp` under the key
    `fold_in(fold_in(key, rids[n]), steps[n])`: (N,) int32 token ids."""
    keys = fold_in(fold_in(key.expand(len(logits), 2), rids), steps)
    return categorical(keys, logits.to(torch.float32) / temp).to(torch.int32)
