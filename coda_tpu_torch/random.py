"""Counter-based random bits that reproduce ``jax.random`` exactly.

The reference engine draws its randomness from JAX's threefry2x32 in the
*partitionable* mode (``coda_tpu/__init__.py`` turns it on): a key is two
uint32 words, ``split`` and ``uniform`` hash ``(key, position)`` with
threefry2x32 over a 64-bit iota. Reproducing the same bits keeps the
tie-break draws of :func:`coda_tpu_torch.ops.masked.masked_argmax_tiebreak`
— and therefore whole per-seed trajectories — identical to the reference.

Keys are explicit ``(2,)`` int64 tensors holding uint32 values; all uint32
arithmetic is emulated in int64 with masking (PyTorch's uint32 dtype lacks
the shifts and xors this needs). A batch of keys is a ``(..., 2)`` tensor
(the seed-batched engine's ``(S, 2)`` replica keys): ``split`` and
``uniform`` then hash every key at once, and row ``s`` of the result is
bitwise the single-key call on key ``s``. Functions run on whichever device
their key or ``device`` argument names; a key is tiny, so the engine
derives its key schedule on the host and only the draws over N (the
tie-break uniforms, the Gumbel noise of ``categorical``) run on the card.

``fold_in``, ``gumbel``, ``categorical`` and ``randint`` follow the
installed jax's defaults: ``categorical`` draws its Gumbel noise in the
"low" mode and ``randint`` takes two 32-bit words a value
(``jax._src.random._gumbel``, ``_randint``).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The 20-round threefry2x32 block cipher, elementwise over the count
    words ``x1``/``x2`` (int64 tensors of uint32 values). ``k1``/``k2`` are
    0-d tensors or Python ints. Returns the two output words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def _iota_2x32(shape: Sequence[int], device) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """A row-major 64-bit iota over ``shape`` as (hi, lo) uint32 words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds: ``[0, seed mod
    2**32]`` (the high word of a 32-bit seed shifted right by 32 is 0)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys, row ``i`` the
    threefry hash of ``key`` at count ``i`` (the partitionable fold-like
    split). A ``(..., 2)`` batch of keys gives ``(..., num, 2)``, as
    ``jax.vmap(jax.random.split)`` does."""
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = threefry2x32(key[..., :1], key[..., 1:], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32-bit random words of ``shape``: the xor of threefry's two output
    words at each position (partitionable mode). ``device`` defaults to
    the key's; a host key may fill a device tensor. A ``(..., 2)`` batch of
    keys gives ``(..., *shape)``; it is copied to ``device`` if it lies
    elsewhere (the engine uploads a run's keys once instead)."""
    device = key.device if device is None else torch.device(device)
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape, device)
    if key.dim() > 1:
        words = key.to(device).reshape(key.shape[:-1] + (1,) * len(shape)
                                       + (2,))
        k1, k2 = words[..., 0], words[..., 1]
    elif key.device == device:
        k1, k2 = key[0], key[1]
    else:
        # a host key enters as two Python ints: copying it to the card
        # would synchronise the stream every round
        k1, k2 = (int(v) for v in key.tolist())
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def _unit_floats(key: torch.Tensor, shape: Sequence[int],
                 device=None) -> torch.Tensor:
    """The float32 values in [0, 1) that ``jax.random.uniform`` builds from
    the top 23 bits of each word (the mantissa of a float in [1, 2),
    minus 1)."""
    bits = random_bits(key, shape, device)
    fbits = (bits >> 9) | 0x3F800000
    # every value is < 2**31, so the int32 view is the same bit pattern
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int],
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1).
    A ``(..., 2)`` batch of keys gives ``(..., *shape)``."""
    return torch.clamp_min(_unit_floats(key, shape, device), 0.0)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the threefry hash of ``key`` at
    the count words ``(0, data mod 2**32)`` (``prng.threefry_fold_in``;
    the same key as ``split(key, data + 1)[data]``). ``data`` is a Python
    int or an integer tensor broadcast against a ``(..., 2)`` batch of
    keys."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


_F32_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, "low" mode:
    ``-log(-log(u))`` with ``u`` the uniform draw on ``[tiny, 1)`` — the
    same mantissa bits as :func:`uniform`, scaled by ``1 - tiny`` (1 in
    float32), shifted by ``tiny`` and clamped at ``tiny``, so a zero word
    gives ``tiny`` instead of 0. A ``(..., 2)`` batch of keys gives
    ``(..., *shape)``."""
    # ``floats * (1 - tiny) + tiny``: 1 - tiny rounds to 1 in float32
    u = torch.clamp_min(_unit_floats(key, shape, device) + _F32_TINY,
                        _F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of Gumbel noise plus the logits (the first index among equal
    maxima). A ``(2,)`` key samples one index per row of ``logits``; a
    ``(S, 2)`` batch of keys with ``(S, N)`` logits samples row s with key
    s, as ``jax.vmap`` gives. The noise is drawn on ``logits``' device."""
    if key.dim() > 1:
        noise = gumbel(key, logits.shape[key.dim() - 1:],
                       device=logits.device)
    else:
        noise = gumbel(key, logits.shape, device=logits.device)
    return torch.argmax(noise + logits, dim=-1)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 values:
    two 32-bit words a value from the two halves of ``split(key)``, folded
    into the span as ``(hi % span * (2**32 % span) + lo % span) % span``
    in uint32 arithmetic (emulated in int64, masked after every multiply
    and add). Runs on the key's device; a ``(..., 2)`` batch of keys gives
    ``(..., *shape)``. Returns int64 values."""
    k = split(key)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = (int(maxval) - int(minval)) & _MASK if maxval > minval else 1
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = (((hi % span) * multiplier) & _MASK) + lo % span
    return int(minval) + (offset & _MASK) % span
