"""JAX's default PRNG (threefry-2x32), ``jax.random.uniform`` and
``jax.random.permutation`` in torch.

Two places of the port draw the JAX package's random numbers bit for bit:
the coreset's sparse random projection (``jax.random.uniform(PRNGKey(seed),
(d, n_components))``, ``ops/coreset.py``) and the ``'jax'`` OCSVM fitter,
which visits its rows each epoch in the order ``jax.random.permutation(
keys[e], n)`` with ``keys = jax.random.split(jax.random.PRNGKey(seed),
max_iter)`` (``fusion/ocsvm.py``).  This is a copy of jax 0.9.0's
``jax/_src/prng.py`` and ``jax/_src/random.py``, written with int64 tensors
that hold uint32 values (masked after every add and shift) so that it runs
on the CPU and the card alike:

* a key is a pair of uint32 words; ``PRNGKey(seed)`` is ``(seed >> 32,
  seed & 0xFFFFFFFF)``;
* ``jax_threefry_partitionable`` is True in that release, so ``split`` and
  ``random_bits`` hash the counter pairs ``(0, i)`` of a flat index ``i``
  and 32 random bits are the XOR of the hash's two output words;
* a float32 ``uniform`` in [0, 1) keeps a draw's top 23 bits as the
  mantissa of a float in [1, 2) and subtracts 1;
* ``permutation`` sorts ``arange(n)`` stably by fresh 32-bit keys,
  ``ceil(3 ln n / ln(2^32 - 1))`` times, each round's keys drawn from a
  subkey split off the running key.
"""

from __future__ import annotations

import numpy as np
import torch

PARTITIONABLE = True     # jax_threefry_partitionable in jax 0.9.0
_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter words (x1, x2) under the key
    (k1, k2); int64 tensors holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s two words, (2,) int64."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    return torch.tensor([seed >> 32, seed & _M], dtype=torch.int64, device=device)


def _hash_counters(keys: torch.Tensor, n: int):
    """The hash of the counters (0, i), i < n, under each key of ``keys``
    (..., 2): two (..., n) words."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(i), i)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key of ``keys`` (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash_counters(keys, num)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``random_bits(key, 32, (n,))`` of each key of ``keys`` (..., 2) ->
    (..., n) int64 in [0, 2^32)."""
    b1, b2 = _hash_counters(keys, n)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)) of one key
    (2,): the bits of the flat index, row-major."""
    n = int(np.prod(shape))
    bits = random_bits32(key, n)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return (mantissa.view(torch.float32) - 1.0).reshape(tuple(shape))


def shuffle_rounds(n: int) -> int:
    """The sort rounds of ``jax.random.permutation`` for ``n`` elements."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutations(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for each key of ``keys`` (E, 2) ->
    (E, n) int64."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(
        keys.shape[0], n).contiguous()
    for _ in range(shuffle_rounds(n)):
        pair = split(keys)                            # (E, 2, 2)
        keys, sub = pair[:, 0], pair[:, 1]
        order = torch.sort(random_bits32(sub, n), dim=1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x
