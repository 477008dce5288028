"""Deterministic synthetic data pipelines.

Counterpart of ``repro/data/synthetic.py``.

LM task: the same learnable affine-recurrence token stream. Every batch is
reproducible from (seed, worker, step) with no pipeline state: the
``torch.Generator`` of a batch is seeded from those three numbers, so
worker shards never overlap. The recurrence is the reference's; the random
bits are torch's, not ``jax.random``'s, so the tokens differ from the JAX
package's (tests that compare the two feed both the same numpy batches).

Classification task: the reference's numpy code verbatim, so its data is
identical to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def batch_generator(seed: int, worker: int, step: int) -> torch.Generator:
    """The CPU generator of one (seed, worker, step) batch."""
    state = np.random.SeedSequence([seed, worker, step]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(
        int(state) & 0x7FFF_FFFF_FFFF_FFFF)


@dataclass(frozen=True)
class TokenTask:
    vocab_size: int
    seq_len: int
    mult: int = 31
    add: int = 17
    noise: float = 0.05

    def sample(self, gen: torch.Generator, batch: int):
        """(batch, seq) int64 token sequences following the noisy affine
        recurrence t_{i+1} = (mult * t_i + add) mod V (on the CPU)."""
        V, S = self.vocab_size, self.seq_len
        tok = torch.randint(0, V, (batch,), generator=gen)
        flip = torch.rand((S - 1, batch), generator=gen) < self.noise
        rnd = torch.randint(0, V, (S - 1, batch), generator=gen)
        toks = [tok]
        for i in range(S - 1):
            tok = torch.where(flip[i], rnd[i], (tok * self.mult + self.add) % V)
            toks.append(tok)
        return torch.stack(toks, dim=1)


def make_lm_batch(task: TokenTask, seed: int, worker: int, step: int,
                  batch: int, cfg=None, *, device):
    """Deterministic per-(worker, step) batch: ``tokens`` and next-token
    ``labels`` (last position -1 = masked)."""
    if cfg is not None and (cfg.n_prefix or cfg.n_enc_layers):
        raise NotImplementedError("not yet ported: prefix / encoder inputs")
    toks = task.sample(batch_generator(seed, worker, step), batch)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    return {"tokens": toks.to(device), "labels": labels.to(device)}


def make_round_batch(task: TokenTask, seed: int, n_workers: int, tau: int,
                     start_step: int, local_batch: int, cfg=None, *, device):
    """Stacked round input (tau, M, B, S). ``start_step`` is the round's
    first GLOBAL step (``RoundSpec.start``)."""
    rows = [[make_lm_batch(task, seed, m, start_step + t, local_batch, cfg,
                           device="cpu") for m in range(n_workers)]
            for t in range(tau)]
    return {k: torch.stack([torch.stack([b[k] for b in row]) for row in rows])
            .to(device) for k in rows[0][0]}


# ---------------------------------------------------------------------------
# Classification task (CIFAR stand-in for the paper tables)
# ---------------------------------------------------------------------------

def classification_task(n_train=2048, n_test=1024, dim=32, n_classes=10,
                        noise=1.8, label_noise=0.15, seed=0, *,
                        device="cuda"):
    """Gaussian clusters with feature noise + TRAIN-set label noise (the
    reference's numpy draws, so the data equals the JAX package's)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 1.0, size=(n_classes, dim))

    def draw(n, flip):
        y = rng.integers(0, n_classes, size=n)
        x = means[y] + noise * rng.normal(size=(n, dim))
        if flip > 0:
            mask = rng.random(n) < flip
            y = np.where(mask, rng.integers(0, n_classes, size=n), y)
        return x.astype(np.float32), y.astype(np.int64)
    xtr, ytr = draw(n_train, label_noise)
    xte, yte = draw(n_test, 0.0)
    t = lambda a: torch.from_numpy(a).to(device)
    return {"x_train": t(xtr), "y_train": t(ytr), "x_test": t(xte),
            "y_test": t(yte), "n_classes": n_classes, "dim": dim}
