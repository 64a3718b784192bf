"""Synthetic datasets (a copy of ``repro.data.synthetic``).

Two generators, both drawing from ``np.random.default_rng``, so they
reproduce the reference bit for bit:

* :func:`lm_batches` — Zipf-distributed token streams with a planted Markov
  structure, so LM training loss decreases measurably within a few hundred
  steps (the train launcher's data).
* :class:`MultitaskDataset` — the paper-style setting: one shared domain
  ``X`` and ``n`` classification tasks over it.  Samples are mixtures of
  per-factor prototypes; each task labels a different latent factor, and
  tasks sharing factors exhibit the affinity structure Antler exploits
  (tasks 2i and 2i+1 share factor groups -> high pairwise affinity).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Language-model streams
# --------------------------------------------------------------------------

def lm_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    seed: int = 0,
    order: int = 2,
) -> Iterator[np.ndarray]:
    """Infinite iterator of (batch, seq_len) int32 token arrays.

    Tokens follow a sparse random ``order``-gram process over a Zipf
    unigram prior: predictable enough that a model visibly learns.
    """
    rng = np.random.default_rng(seed)
    # Zipf unigram prior over the first min(vocab, 4096) types.
    v_eff = min(vocab_size, 4096)
    ranks = np.arange(1, v_eff + 1)
    prior = 1.0 / ranks
    prior /= prior.sum()
    # Each context hashes to a small candidate set -> planted structure.
    table = rng.integers(0, v_eff, size=(8192, 4))

    while True:
        out = np.empty((batch, seq_len), dtype=np.int32)
        state = rng.choice(v_eff, size=(batch, order), p=prior)
        for t in range(seq_len):
            ctx = (state[:, 0] * 31 + state[:, 1] * 7) % 8192
            cands = table[ctx]                       # (batch, 4)
            pick = rng.integers(0, 4, size=batch)
            nxt = cands[np.arange(batch), pick]
            # 10% noise from the prior keeps entropy non-trivial.
            noise = rng.random(batch) < 0.1
            nxt = np.where(noise, rng.choice(v_eff, size=batch, p=prior), nxt)
            out[:, t] = nxt
            state = np.concatenate([state[:, 1:], nxt[:, None]], axis=1)
        yield out


# --------------------------------------------------------------------------
# Multitask classification over a shared domain (paper setting)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MultitaskDataset:
    """n classification tasks over one image-like domain X.

    Latent factors: ``num_factors`` independent categorical factors, each
    rendered as an additive spatial prototype.  Task t labels factor
    ``factor_of_task[t]``; tasks sharing a factor (or correlated factors)
    have high affinity — giving the task-graph machinery real structure.
    """

    num_tasks: int = 5
    num_classes: int = 10
    hw: Tuple[int, int, int] = (28, 28, 1)
    num_factors: int = 3
    noise: float = 0.3
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        h, w, c = self.hw
        self.prototypes = rng.normal(
            size=(self.num_factors, self.num_classes, h, w, c)
        ).astype(np.float32)
        # Map tasks onto factors so consecutive task pairs share a factor.
        self.factor_of_task = [t % self.num_factors for t in range(self.num_tasks)]
        # Per-task random label permutation: tasks on the same factor are
        # related but not identical.
        self.label_perm = [
            rng.permutation(self.num_classes) for _ in range(self.num_tasks)
        ]
        self._rng = rng

    def sample(self, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (x (B,H,W,C) float32, labels (num_tasks, B) int32)."""
        rng = self._rng
        zs = rng.integers(0, self.num_classes, size=(self.num_factors, batch))
        h, w, c = self.hw
        x = np.zeros((batch, h, w, c), dtype=np.float32)
        for f in range(self.num_factors):
            x += self.prototypes[f, zs[f]]
        x += self.noise * rng.normal(size=x.shape).astype(np.float32)
        labels = np.stack(
            [self.label_perm[t][zs[self.factor_of_task[t]]] for t in range(self.num_tasks)]
        ).astype(np.int32)
        return x, labels

    def batches(self, batch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.sample(batch)


def train_test_split(
    ds: MultitaskDataset, n_train: int, n_test: int
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Paper §6.1: 80/20-style fixed train/test draws."""
    xtr, ytr = ds.sample(n_train)
    xte, yte = ds.sample(n_test)
    return (xtr, ytr), (xte, yte)
