"""Deterministic synthetic LM data (the port's ``repro/data/pipeline.py``).

Token streams from a fixed random bigram chain, so that a model has real
(learnable) structure: training drives the loss toward the bigram entropy
floor.  A batch is a pure function of (seed, step, dp_rank): every
data-parallel rank draws its own shard with no coordination, and a
restarted job draws the same batches again.  numpy arrays, the reference's
bits; the caller moves them to its device.  The reference's
``make_batch_specs`` (its dry run's ``ShapeDtypeStruct`` stand-ins) has no
counterpart here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLMData"]


class SyntheticLMData:
    def __init__(self, vocab: int, *, seed: int = 0, branch: int = 4):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # sparse bigram chain: each token transitions to `branch` successors
        self.succ = rng.integers(0, vocab, (vocab, branch), dtype=np.int64)
        self._seed = seed

    def batch(self, step: int, batch: int, seq: int, dp_rank: int = 0,
              enc: tuple | None = None) -> dict:
        """dict(tokens, targets[, enc_input]) as numpy arrays: int32 [batch,
        seq] tokens and their next tokens; ``enc=(frames, d_model)`` adds
        float32 N(0, 1) frames [batch, frames, d_model]."""
        rng = np.random.default_rng(
            (self._seed * 7_777_777 + step * 131 + dp_rank) & 0x7FFFFFFF
        )
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        choices = rng.integers(0, self.succ.shape[1], (batch, seq))
        for i in range(seq):
            toks[:, i + 1] = self.succ[toks[:, i], choices[:, i]]
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
        if enc is not None:
            frames, d_model = enc
            out["enc_input"] = rng.normal(size=(batch, frames, d_model)).astype(np.float32)
        return out

    def bigram_entropy(self) -> float:
        """Loss floor in nats (uniform over `branch` successors, modulo
        collisions)."""
        return float(np.log(self.succ.shape[1]))
