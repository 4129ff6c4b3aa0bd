"""Deterministic synthetic LM data: Zipfian unigrams + Markov bigram
structure, generated per (seed, step) so any batch is reproducible on its
own — restart-after-failure resumes the exact stream (no data-order drift),
and each data shard can be generated independently on its host.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_strength: float = 0.7   # prob of following the bigram chain


class SyntheticLM:
    """Batch generator. ``batch_for_step(k)`` is a pure function of (cfg, k)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = ranks ** -cfg.zipf_a
        self._unigram /= self._unigram.sum()
        # a fixed random bigram successor table gives learnable structure
        self._successor = rng.integers(0, V, size=V)

    def batch_for_step(self, step: int, batch_slice=None) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B = cfg.global_batch if batch_slice is None else batch_slice
        S = cfg.seq_len + 1
        iid = rng.choice(cfg.vocab_size, size=(B, S), p=self._unigram)
        follow = rng.random((B, S)) < cfg.markov_strength
        toks = iid.copy()
        for t in range(1, S):
            chain = self._successor[toks[:, t - 1]]
            toks[:, t] = np.where(follow[:, t], chain, iid[:, t])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def frontend_for_step(self, step: int, frontend_len: int, d_model: int,
                          batch=None) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 7))
        B = batch or cfg.global_batch
        return (rng.standard_normal((B, frontend_len, d_model)) * 0.02
                ).astype(np.float32)
