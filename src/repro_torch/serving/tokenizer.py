"""Deterministic byte-level tokenizer (no pretrained vocab offline).

Byte values map to ids [SPECIAL .. SPECIAL+255]; ids beyond that range
decode to a replacement glyph. Enough to drive real token streams
through the engine and middleware (the models are randomly initialized,
so text quality is not the point — token *timing* is).
"""

from __future__ import annotations

BOS, EOS, PAD = 0, 1, 2
SPECIAL = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size >= SPECIAL + 256, vocab_size
        self.vocab_size = vocab_size
        self.bos_id, self.eos_id, self.pad_id = BOS, EOS, PAD

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + SPECIAL for b in text.encode("utf-8")]
        return ([BOS] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        bs = bytes(i - SPECIAL for i in ids if SPECIAL <= i < SPECIAL + 256)
        return bs.decode("utf-8", errors="replace")

    def decode_token(self, i: int) -> str:
        if SPECIAL <= int(i) < SPECIAL + 256:
            return bytes([int(i) - SPECIAL]).decode("utf-8", errors="replace")
        return ""

    def count(self, text: str) -> int:
        return len(text.encode("utf-8")) + 1
