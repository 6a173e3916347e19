"""Toy deterministic tokenizer for the synthetic VQA corpus (the port's copy
of ``repro.data.tokenizer``).

Fixed id layout (low ids are special so any vocab ≥ 64 works, including the
reduced smoke vocab of 512):

    0 PAD   1 BOS   2 EOS   3 Q_START   4 Q_END   5 ANS_SEP
    [8,  8+n_topic_words)   topic keywords
    [40, 40+n_answers)      answer tokens
    [64, vocab)             filler words (hash bucket)
"""
from __future__ import annotations

from dataclasses import dataclass

PAD, BOS, EOS, Q_START, Q_END, ANS_SEP = 0, 1, 2, 3, 4, 5
TOPIC_BASE = 8
ANSWER_BASE = 40
FILLER_BASE = 64


@dataclass(frozen=True)
class ToyTokenizer:
    vocab_size: int
    n_topics: int = 8
    n_answers: int = 16

    def topic_token(self, topic: int) -> int:
        return TOPIC_BASE + (topic % self.n_topics)

    def answer_token(self, answer: int) -> int:
        return ANSWER_BASE + (answer % self.n_answers)

    def filler_token(self, h: int) -> int:
        span = max(self.vocab_size - FILLER_BASE, 1)
        return FILLER_BASE + (h % span)

    def is_answer(self, tok: int) -> bool:
        return ANSWER_BASE <= tok < ANSWER_BASE + self.n_answers

    def decode_answer(self, tok: int) -> int:
        return tok - ANSWER_BASE
