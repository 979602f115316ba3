"""Threefry-2x32 keys and draws, bit-exact to ``jax.random`` (jax 0.9 with
``jax_threefry_partitionable=True``, its default).

The port needs the reference's exact random numbers wherever a key reaches
the wire or the model: the b=1 upload dither, the flush's broadcast seeds,
the CNN's dropout mask and the simulator's key stream. The law, checked
against the installed jax in ``tests/test_torch_prng.py``:

* ``PRNGKey(s)`` is the word pair ``[0, s]`` (``s`` < 2**32);
* with ``(w0_i, w1_i) = threefry2x32(key, (hi=0, lo=i))``, ``split(key, n)[i]``
  is ``(w0_i, w1_i)`` and a 32-bit draw of n elements is ``w0_i ^ w1_i``;
* ``uniform`` puts the top 23 bits into the mantissa of 1.x and subtracts 1;
* ``bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``;
* ``permutation(key, n)`` is jax's ``_shuffle`` of ``arange(n)``:
  ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each ``key, sub = split(key)``
  and a stable sort of the values by the 32-bit draw ``bits(sub, (n,))``;
  ``choice(key, n, k)`` without replacement is its first k values.

A key is an int64 tensor of shape (2,) holding the two uint32 words.
torch has no uint32 shifts or adds on the CPU, so every word lives in an
int64 and is masked back to 32 bits after each add or shift. The key words
stay tensors through the cipher (never Python ints), so every function
here runs under ``torch.func.vmap`` over a stack of keys — the cohort
engine draws each member's dropout masks that way — and a draw lands on
the key's device unless ``device`` says otherwise.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> torch.Tensor:
    """The key of a non-negative 32-bit seed: words ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def key_words(key) -> tuple:
    """The two uint32 words of a key, as Python ints."""
    words = torch.as_tensor(key).reshape(-1).tolist()
    if len(words) != 2:
        raise ValueError(f"a key holds two uint32 words, got {words}")
    return int(words[0]) & MASK32, int(words[1]) & MASK32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 block cipher (20 rounds) of counter words
    ``(x0, x1)`` under ``key``; int64 tensors of uint32 values in and out.
    ``key[..., 0]`` and ``key[..., 1]`` broadcast against the counters.
    The rounds update two fresh tensors in place (the inputs are left as
    they are), which on the CPU takes less than half the time of a new
    tensor per operation."""
    key = torch.as_tensor(key)
    k0, k1 = key[..., 0] & MASK32, key[..., 1] & MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (t.contiguous() for t in torch.broadcast_tensors(
        (x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            left = (x1 << r).bitwise_and_(MASK32)  # rotl(x1, r) ^ x0
            x1.bitwise_right_shift_(32 - r).bitwise_or_(left).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK32)
    return x0, x1


def _counter_words(key, n: int, device):
    key = torch.as_tensor(key)
    lo = torch.arange(n, dtype=torch.int64,
                      device=key.device if device is None else device)
    return threefry2x32(key, torch.zeros_like(lo), lo)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: a (num, 2) int64 stack of keys."""
    w0, w1 = _counter_words(key, int(num), None)
    return torch.stack([w0, w1], dim=1)


def split_each(keys, num: int = 2) -> torch.Tensor:
    """``jax.vmap(jax.random.split)``: split each key of a (B, 2) stack,
    giving a (B, num, 2) stack."""
    keys = torch.as_tensor(keys)
    lo = torch.arange(int(num), dtype=torch.int64, device=keys.device)
    w0, w1 = threefry2x32(keys[:, None, :], torch.zeros_like(lo), lo)
    return torch.stack([w0, w1], dim=-1)


def bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: uint32 values in an int64 tensor."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    w0, w1 = _counter_words(key, n, device)
    return (w0 ^ w1).reshape(shape)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    # jax sets the top 23 bits as the mantissa of 1.m and subtracts 1,
    # which is exactly m * 2**-23: m converts to f32 exactly, the scale is
    # a power of two (and no bit view, which vmap cannot batch)
    return (bits(key, shape, device) >> 9).to(torch.float32) * 2.0 ** -23


def uniform_range(key, start: int, count: int, device=None) -> torch.Tensor:
    """Elements ``[start, start + count)`` of the flattened ``uniform(key,
    shape)`` of any shape holding them (element i's counter is ``(0, i)``,
    for ``start + count <= 2**32``): the dither of a row chunk of a
    message, without drawing the rows before it."""
    key = torch.as_tensor(key)
    lo = torch.arange(int(start), int(start) + int(count), dtype=torch.int64,
                      device=key.device if device is None else device)
    w0, w1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return ((w0 ^ w1) >> 9).to(torch.float32) * 2.0 ** -23


def bernoulli(key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` (p as f32)."""
    return uniform(key, shape, device) < p


def _shuffle_rounds(n: int) -> int:
    """Sort rounds of jax's shuffle of n values (2 at n = 2048, 1 at
    n = 1000): enough that all n 32-bit sort keys differ in some round
    with high probability."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))


def permutation(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a shuffle of ``arange(n)``
    (int64) by stable sorts on fresh 32-bit draws (module docstring)."""
    key = torch.as_tensor(key)
    dev = key.device if device is None else torch.device(device)
    x = torch.arange(int(n), dtype=torch.int64, device=dev)
    for _ in range(_shuffle_rounds(int(n))):
        key, sub = split(key)
        order = torch.sort(bits(sub, (int(n),), device=dev),
                           stable=True).indices
        x = x[order]
    return x


def choice(key, n: int, k: int, device=None) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: k distinct
    indices of ``range(n)`` (int64), the first k of ``permutation``."""
    if not 0 <= int(k) <= int(n):
        raise ValueError(f"cannot choose {k} of {n} without replacement")
    return permutation(key, n, device)[:int(k)]


def key_words_i32(keys: torch.Tensor) -> torch.Tensor:
    """Keys (int64 tensors of uint32 words) as int32 tensors holding the
    same bit patterns — what a kernel reads as uint32."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)
