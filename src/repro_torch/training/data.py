"""Synthetic LM data pipeline with checkpointable iterator state: the JAX
package's ``training/data.py``, the same numpy code, so both packages
draw the same batches token for token.

Deterministic: stream position is a single integer, so restarts resume
exactly (the manifest stores it). Token distribution is Zipf-ish over
the vocab with injected n-gram structure so the loss actually decreases
during the example training run.
"""

from __future__ import annotations

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 extra_fn=None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0
        self.extra_fn = extra_fn  # per-batch extra inputs (vision/frames stubs)
        # fixed Zipf weights + a small Markov structure
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def next(self):
        rng = np.random.default_rng((self.seed << 20) + self.step)
        toks = rng.choice(self.vocab_size, size=(self.batch, self.seq_len),
                          p=self._probs).astype(np.int32)
        # inject learnable bigram structure: even positions predict pos+1
        toks[:, 1::2] = (toks[:, 0::2] * 7 + 13) % self.vocab_size
        self.step += 1
        batch = {"tokens": toks}
        if self.extra_fn is not None:
            batch["extra"] = self.extra_fn(rng, self.batch)
        return batch

    def __iter__(self):
        while True:
            yield self.next()
