"""`jax.random`'s threefry draws, bit for bit, as torch ops.

The stochastic families (the tree ensembles and the MLP; KMeans in a
later slice) match the reference only if they draw the same numbers
from the same seed.  This module reproduces the few `jax.random`
functions they call, as jax 0.9 computes them with
``jax_threefry_partitionable=True`` (its default):

- `PRNGKey(seed)`: the key ``[0, seed mod 2**32]`` (jax truncates the
  seed to 32 bits when x64 is off);
- `split(key, n)`: ``threefry2x32(key, (hi(i), lo(i)))`` for i < n, the
  two output words forming key i (`_threefry_split_foldlike`,
  jax/_src/prng.py:1156);
- `fold_in(key, data)`: ``threefry2x32(key, (0, data))`` (prng.py:1168);
- `uniform(key, shape, minval, maxval)`: 32 random bits an element,
  ``bits1 ^ bits2`` of ``threefry2x32(key, (hi(i), lo(i)))`` over the
  flat index i of `shape` (prng.py:1184), made a float32 in [0, 1) by
  the mantissa trick, scaled and shifted to [minval, maxval), then
  ``max(minval, ·)`` (`_uniform`, jax/_src/random.py:435);
- `poisson_one(key, shape)`: ``poisson(key, 1.0, shape)`` by Knuth's
  method, the branch jax takes for lam < 10 (`_poisson_knuth`,
  random.py:1547): round i splits the key and draws one uniform u_i
  over the whole shape, the loop runs while any element's log-product
  is above -lam, and the draw is the count of rounds whose log-product
  stays above it;
- `permutation(key, n)`: `_shuffle` (jax/_src/random.py:700), which
  sorts ``arange(n)`` by 32 random bits an element (`uniform`'s bits)
  in ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each round under the
  second key of ``split(key)`` (the first carries on), with a stable
  sort (`lax.sort_key_val`): 1 round up to n = 1625, 2 from 1626;
  `permutations` draws several keys' permutations in one pass.

Keys are numpy uint32 arrays, (2,) or (n, 2), and live on the host: a
key is two words, and deriving one is a few dozen integer operations on
numbers (the same `threefry2x32` body as the device draws).  The draws
go to the `device` asked for, as int64 tensors masked to 32 bits
(torch's uint32 has only partial CUDA coverage).  Draws that share a
shape take one pass: `uniform_many` draws a row per key,
`uniform_ragged` one run of each length per key, and
`poisson_one` draws its rounds 16 at a time (a log-product only falls,
so rounds drawn past the loop's end count nothing).  The one float step
that is not exact, the float32 `log` of Poisson's product, can differ
from XLA's by an ulp; it changes a draw only where a log-product lands
within that ulp of -lam.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: Poisson rounds drawn in one pass
POISSON_ROUNDS = 16

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as `_threefry2x32_lowering` computes
    it: key words k0, k1 and counter words x0, x1 (numpy uint64 arrays or
    int64 tensors holding 32-bit values, broadcast together); returns
    the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key):
    key = np.asarray(key, np.uint64)
    return key[..., 0], key[..., 1]


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): a (2,) uint32 key."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    k0, k1 = _words(key)
    i = np.arange(num, dtype=np.uint64)
    b0, b1 = threefry2x32(k0, k1, i >> np.uint64(32), i & np.uint64(_MASK))
    return np.stack([b0, b1], axis=-1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data): a (2,) uint32 key."""
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, np.uint64(0),
                          np.uint64(int(data) & _MASK))
    return np.array([b0, b1], np.uint32)


def _bits(keys, n: int, device):
    """(R, n) int64 tensor of 32-bit random words: row r under keys[r]."""
    keys = torch.as_tensor(np.asarray(keys, np.int64).reshape(-1, 2),
                           device=device)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], i >> 32, i & _MASK)
    return b0 ^ b1


def _to_uniform(bits, minval=0.0, maxval=1.0):
    one = 0x3F800000                        # the bits of 1.0f
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    if (minval, maxval) != (0.0, 1.0):
        # ``f * (maxval - minval) + minval`` contracted into one FMA, as
        # XLA's CPU backend compiles it: the float32 product is exact in
        # float64, so one float64 sum rounded to float32 is the FMA's value
        span = np.float32(maxval) - lo
        f = (f.double() * float(span) + float(lo)).float()
    return torch.clamp_min(f, float(lo))


def uniform(key, shape: Shape, device=None, minval=0.0, maxval=1.0):
    """jax.random.uniform(key, shape, minval=minval, maxval=maxval) in
    float32 on [minval, maxval)."""
    shape = _shape(shape)
    return _to_uniform(_bits(key, int(np.prod(shape)), device), minval,
                       maxval).reshape(shape)


def uniform_many(keys, shape: Shape, device=None):
    """``stack([uniform(k, shape) for k in keys])`` in one pass: (R,
    *shape) float32."""
    shape = _shape(shape)
    keys = np.asarray(keys).reshape(-1, 2)
    bits = _bits(keys, int(np.prod(shape)), device)
    return _to_uniform(bits).reshape((len(keys),) + shape)


def uniform_ragged(keys, sizes: Sequence[int], device=None):
    """``cat([uniform(k, (m,)) for k, m in zip(keys, sizes)])`` in one
    pass: a flat float32 tensor."""
    keys = torch.as_tensor(np.asarray(keys, np.int64).reshape(-1, 2),
                           device=device)
    sizes_t = torch.as_tensor(np.asarray(sizes, np.int64), device=device)
    starts = torch.cumsum(sizes_t, 0) - sizes_t
    total = int(np.sum(sizes))
    i = (torch.arange(total, dtype=torch.int64, device=device)
         - torch.repeat_interleave(starts, sizes_t, output_size=total))
    k = torch.repeat_interleave(keys, sizes_t, dim=0, output_size=total)
    b0, b1 = threefry2x32(k[:, 0], k[:, 1], i >> 32, i & _MASK)
    return _to_uniform(b0 ^ b1)


def poisson_one(key, shape: Shape, device=None):
    """jax.random.poisson(key, 1.0, shape) as int32 (Knuth's branch)."""
    shape = _shape(shape)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=device)
    count = torch.zeros(shape, dtype=torch.int32, device=device)
    neg_lam = -1.0
    rng = np.asarray(key, np.uint32)
    while True:
        subs = []
        for _ in range(POISSON_ROUNDS):
            rng, sub = split(rng)
            subs.append(sub)
        logs = torch.log(uniform_many(np.stack(subs), shape, device))
        # the rounds' log-products, added in the reference's order
        for i in range(POISSON_ROUNDS):
            log_prod = log_prod + logs[i]
            count += (log_prod > neg_lam).to(torch.int32)
        if not bool((log_prod > neg_lam).any()):
            return count


def permutation(key, n: int, device=None):
    """jax.random.permutation(key, n): an int64 tensor holding a
    permutation of ``range(n)``."""
    return permutations(np.asarray(key)[None], n, device)[0]


def permutations(keys, n: int, device=None):
    """``stack([permutation(k, n) for k in keys])`` in one pass: (R, n)
    int64; each round's bits for every key are drawn together and
    sorted row by row."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device).expand(
        len(keys), n)
    subs = []
    for _ in range(rounds):
        pairs = [split(k) for k in keys]
        keys = np.stack([p[0] for p in pairs])
        subs.append(np.stack([p[1] for p in pairs]))
    if not subs:
        return x.contiguous()
    bits = _bits(np.concatenate(subs), n, device).view(rounds, -1, n)
    for r in range(rounds):
        order = torch.sort(bits[r], dim=1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x
