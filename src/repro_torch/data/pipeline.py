"""Deterministic synthetic LM data pipeline (copy of ``repro/data/pipeline.py``).

Produces learnable structure (a noisy Markov chain over the vocab) rather
than uniform noise, so end-to-end training examples show a real loss drop.
Host-side NumPy, deterministic per (seed, step): a restart resumes the
stream exactly (checkpoint stores only the step counter), which is what
makes the fault-tolerance story exact-restart (ft/runner.py).
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Noisy-Markov token stream: token_{t+1} = (a * token_t + b) % V with
    probability (1-noise), else uniform."""

    def __init__(self, vocab: int, seed: int = 0, noise: float = 0.1):
        self.vocab = vocab
        self.seed = seed
        self.noise = noise
        self.a = 31 if vocab > 31 else 3
        self.b = 7

    def batch(self, step: int, batch: int, seq: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        noise_mask = rng.random((batch, seq)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (batch, seq))
        for t in range(seq):
            nxt = (self.a * toks[:, t] + self.b) % self.vocab
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def frontend_batch(self, step: int, batch: int, seq: int, d_model: int,
                       frontend_tokens: int = 0) -> dict:
        """Batch for stub-frontend archs: embeddings + (optional) text tokens."""
        out = self.batch(step, batch, seq)
        rng = np.random.default_rng((self.seed, step, 1))
        if frontend_tokens:          # vision: patches ahead of text
            out["tokens"] = out["tokens"][:, : seq - frontend_tokens]
            emb = rng.standard_normal((batch, frontend_tokens, d_model), np.float32)
        else:                        # audio: every position is a frame embed
            out.pop("tokens")
            emb = rng.standard_normal((batch, seq, d_model), np.float32)
        out["frontend_embeds"] = emb * 0.02
        return out


def make_batch_iterator(cfg, batch: int, seq: int, seed: int = 0, start_step: int = 0):
    """Infinite iterator of numpy batches for an arch config.

    Only ``vision_stub`` takes patches ahead of its tokens: an audio config's
    ``frontend_tokens`` (4 in every smoke config with a frontend) is not
    passed on, so its batches hold a frame embedding at every position.  The
    reference passes it, and its audio smoke batches hold 4 frames against
    ``seq`` labels (ROADMAP C-ref-7).
    """
    src = SyntheticLM(cfg.vocab, seed=seed)
    patches = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    step = start_step
    while True:
        if cfg.frontend == "none":
            yield step, src.batch(step, batch, seq)
        else:
            yield step, src.frontend_batch(step, batch, seq, cfg.d_model, patches)
        step += 1
