"""Batched sampling for the decode loop: temperature, top-k and top-p
(nucleus) filtering over ``(..., V)`` logits (counterpart of
``repro/serving/sampling.py``).

The filters compose in the standard order temperature -> top-k -> top-p (a
token must survive both truncations). Greedy decoding is the
``temperature == 0`` corner and ignores the key; it equals the
reference's token for token.

Keys are the port's own: a key is a non-negative int64 seed, ``fold_in``
derives a new one with a splitmix64 hash, and a draw seeds a
``torch.Generator`` on the logits' device from its key and takes the
Gumbel-max of the masked logits. The JAX package's keys and
``jax.random.categorical`` draw other numbers, so sampled tokens are NOT
expected to equal the reference's; only their contract carries over
(reproducible, one key per draw, independent rows).

``SamplingParams`` is a frozen dataclass; validation raises ``ValueError``
(not assert) so it survives ``python -O``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingParams:
    """top_k == 0 and top_p == 1.0 disable the respective truncation;
    temperature == 0.0 means greedy (argmax)."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams(temperature=0.0)


def fold_in(key: int, i: int) -> int:
    """A new key from ``key`` and the integer ``i`` (splitmix64 of their
    mix; 63 bits, so it fits an int64 seed). ``fold_in(k, i) != k`` for
    the keys the serving engine uses."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(i) + 0x632BE59BD9B4E019) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def fold_in_array(keys, i):
    """``fold_in`` elementwise over arrays of keys and indices, in numpy
    uint64 arithmetic (which wraps as the mask does). Returns int64."""
    u = lambda v: np.asarray(v, np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        z = u(keys) * np.uint64(0x9E3779B97F4A7C15) + u(i) \
            + np.uint64(0x632BE59BD9B4E019)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return ((z ^ (z >> np.uint64(31))) >> np.uint64(1)).astype(np.int64)


def _top_k_mask(logits, k):
    """Keep the k largest logits per row (ties at the threshold all
    survive, as in the reference)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, NEG_INF)


def _top_p_mask(logits, p):
    """Nucleus: keep the smallest prefix of the probability-sorted vocab
    whose mass reaches p. The exclusive cumulative sum keeps the first
    token unconditionally, so the mask never empties the vocab."""
    sort = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sort, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    thresh = torch.amin(torch.where(mass_before < p, sort, torch.inf),
                        dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, NEG_INF)


def mask_logits(logits, sp: SamplingParams):
    """Temperature + top-k + top-p over ``(..., V)`` logits. Greedy and the
    no-op params (temperature 1, top_k 0, top_p 1) return the input
    itself."""
    if sp.greedy:
        return logits
    x = logits
    if sp.temperature != 1.0:
        x = x / sp.temperature
    if sp.top_k:
        x = _top_k_mask(x, min(sp.top_k, x.shape[-1]))
    if sp.top_p < 1.0:
        x = _top_p_mask(x, sp.top_p)
    return x


def _gumbel_pick(x, key: int):
    """One categorical draw per row of ``x`` (..., V) with one key: the
    argmax of x plus Gumbel noise from a generator seeded with ``key``."""
    gen = torch.Generator(device=x.device).manual_seed(int(key))
    u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                   device=x.device)
    g = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return torch.argmax(x.to(torch.float32) + g, dim=-1)


def sample_token(logits, key: int, sp: SamplingParams):
    """Token ids from ``(..., V)`` logits: one draw per row, all rows
    from the one ``key`` (a 0-d int64 tensor for a ``(V,)`` row)."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1)
    return _gumbel_pick(mask_logits(logits, sp), key)


def sample_batch(logits, keys, sp: SamplingParams):
    """(B, V) logits + B keys -> (B,) tokens, one independent draw per
    row."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1)
    x = mask_logits(logits, sp)
    return torch.stack([_gumbel_pick(row, k) for row, k in zip(x, keys)])


__all__ = ["GREEDY", "NEG_INF", "SamplingParams", "fold_in", "fold_in_array",
           "mask_logits", "sample_batch", "sample_token"]
