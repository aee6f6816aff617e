"""Speculative-decoding draft sources for the continuous batcher (the JAX
package's ``serving/speculative.py``).

The scheduler's speculative tick needs k proposed tokens per slot; this
module provides the two sources and the counters they share:

* :class:`ModelDrafter` -- a second, cheaper model registered as the
  drafter (STREAM's cross-tier pairing: the local tier's model drafts
  for the HPC tier's verifier). It keeps its own contiguous
  (B, max_seq) cache beside the batcher's slots: at admission the
  prompt is prefilled at batch 1 in page-aligned pieces and spliced
  into the slot's row; each tick ``propose_k`` ingests every slot's last
  emitted token and k greedy continuations (contiguous decode, the
  ``decode_attention`` kernel on the card). Rollback is free: the next
  tick hands the drafter the verifier's post-acceptance positions, so
  the accepted prefix of its own writes stays valid and the rejected
  tail is dead until overwritten. Recurrent families cannot roll a state
  back that way, which is why only models with ``propose_k`` qualify.

* :class:`NgramDrafter` -- prompt-lookup self-drafting on the host: the
  continuation that followed the most recent earlier occurrence of the
  sequence's tail n-gram.

Neither source changes what is emitted: ``sampler.speculative_accept``
replays the target's own sample stream, so a bad draft costs speed only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import cache_layout, round_up
from repro_torch.serving.pagepool import SlotSplicer, chunk_plan


@dataclass
class SpecStats:
    """Per-batcher speculative counters (host side, cumulative)."""
    proposed: int = 0        # draft tokens offered to the verifier
    accepted: int = 0        # draft tokens that matched the target draw
    emitted: int = 0         # tokens emitted by speculative ticks
    spec_ticks: int = 0      # fused verify steps
    plain_ticks: int = 0     # ticks that ran plain decode

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_tick(self) -> float:
        return self.emitted / max(self.spec_ticks, 1)


class NgramDrafter:
    """Prompt-lookup self-drafting: match the longest tail n-gram of the
    sequence so far against its own history and propose what followed
    the most recent earlier occurrence."""

    def __init__(self, k: int = 4, ngrams=(3, 2, 1)):
        self.k = k
        self.ngrams = tuple(sorted(ngrams, reverse=True))

    def propose(self, ids: list) -> list:
        for n in self.ngrams:
            if len(ids) <= n:
                continue
            tail = ids[-n:]
            for i in range(len(ids) - n - 1, -1, -1):
                if ids[i:i + n] == tail:
                    out = ids[i + n:i + n + self.k]
                    if out:
                        return out
                    break
        return []


@dataclass
class DraftModel:
    """A drafter registered on a ServingEngine: the model, its params and
    its config (its vocabulary is the verifier's: acceptance compares
    token ids)."""
    model: object
    params: object
    cfg: object


class ModelDrafter:
    """A model drafter's state on one batcher: a private contiguous
    (B, max_seq) cache. Its splice traffic is counted apart
    (``bytes_copied``), not in the batcher's ``bytes_copied_per_admission``,
    which is about the verifier's KV plumbing."""

    def __init__(self, draft: DraftModel, slots: int, max_seq: int, *,
                 page: int, k: int, device="cpu"):
        self.model, self.params, self.cfg = draft.model, draft.params, draft.cfg
        self.k = k
        self.page = page
        self.max_seq = max_seq
        self.device = device
        self.cache = self.model.init_cache(slots, max_seq, device)
        self.cache["pos"] = torch.zeros((slots,), dtype=torch.int32, device=device)
        self._splicer = SlotSplicer(cache_layout(self.model.cache_specs()))

    @property
    def bytes_copied(self) -> int:
        return self._splicer.bytes_copied

    def admit(self, slot: int, ids: list):
        """Prefill the prompt through the drafter (batch 1, page-aligned
        pieces) and splice it into the slot's row."""
        one = self.model.init_cache(1, self.max_seq, self.device)
        off = 0
        for n in chunk_plan(0, len(ids), self.page):
            chunk = torch.tensor([ids[off:off + n]], dtype=torch.int64, device=self.device)
            _, one = self.model.prefill_chunk(self.params, chunk, one)
            off += n
        self._splicer(self.cache, one, slot, min(round_up(len(ids), self.page),
                                                  self.max_seq))

    def propose(self, tok, pos):
        """One draft step for the whole batch: ``tok`` (B, 1) is each
        slot's last emitted token, ``pos`` (B,) the verifier's
        post-acceptance positions (device). Returns drafts (B, k) on the
        device; the drafter's cache advances."""
        cache = dict(self.cache)
        cache["pos"] = pos
        drafts, self.cache = self.model.propose_k(self.params, tok, cache, self.k)
        return drafts
