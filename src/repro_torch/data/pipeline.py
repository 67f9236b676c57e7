"""Deterministic synthetic LM data (the port's ``repro/data/pipeline.py``).

Token streams from a fixed random bigram chain, so that a model has real
(learnable) structure: training drives the loss toward the bigram entropy
floor.  A batch is a pure function of (seed, step, dp_rank): every
data-parallel rank draws its own shard with no coordination, and a
restarted job draws the same batches again.  numpy arrays, the reference's
bits; the caller moves them to its device.  :func:`make_batch_specs` gives
the dry run's stand-ins of a batch (``meta`` tensors, the reference's
``ShapeDtypeStruct``s) and :func:`batch_sharding` their placements on a
mesh.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SyntheticLMData", "batch_sharding", "make_batch_specs"]


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


def make_batch_specs(cfg, shape, *, batch: int | None = None) -> dict:
    """A training batch's stand-ins as ``meta`` tensors (shapes and dtypes,
    no storage): int32 ``tokens`` and ``targets`` [B, S] and, for an
    encoder-decoder, float32 ``enc_input`` [B, enc_frames, d_model]; B is
    ``batch`` or the shape's global batch, S its sequence length."""
    B = batch or shape.global_batch
    S = shape.seq_len
    specs = {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
        "targets": torch.empty((B, S), dtype=torch.int32, device="meta"),
    }
    if cfg.is_encdec:
        specs["enc_input"] = torch.empty((B, cfg.enc_frames, cfg.d_model),
                                         dtype=torch.float32, device="meta")
    return specs


def batch_sharding(batch: dict, rules) -> dict:
    """Each batch tensor's :class:`repro_torch.sharding.NamedSharding`: its
    rows on the "batch" axes and every other dim whole, as the reference's
    dry run places it (``resolve_spec(("batch", None, ...))``)."""
    from repro_torch.sharding import NamedSharding, resolve_spec

    return {k: NamedSharding(rules.mesh, resolve_spec(("batch",) + (None,) * (v.ndim - 1),
                                                      tuple(v.shape), rules))
            for k, v in batch.items()}
