"""Synthetic multimodal VQA corpus with planted topic structure
(the port's numpy copy of ``repro.data.synthetic``; the same seeds give the
same examples).

Real ScienceQA/IconQA + pretrained encoders are unavailable offline
(DESIGN.md §6.1); instead each example is generated from a latent *topic*:

    topic t  ->  image embedding cluster   μ_t + σ·noise   (frontend stub)
             ->  question template         [Q_START, topic word, fillers, Q_END]
             ->  answer                    a = (t·3 + detail) mod n_answers

``detail`` is a per-example attribute carried by BOTH the image embedding
(second moment direction) and a question token, so the task is genuinely
multimodal: the text stream alone identifies the topic but not the detail
(⇒ 𝒜_T alone is weak, as the paper's Tab. 6 finds for vision-centric VQA),
while the image stream carries the disambiguating signal for 𝒜_I.

Dirichlet partitioning over topics (repro_torch.data.partition) then yields
non-IID client shards with *real* covariate and label shift.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.data.tokenizer import (
    ANS_SEP,
    BOS,
    EOS,
    PAD,
    Q_END,
    Q_START,
    ToyTokenizer,
)


@dataclass
class Example:
    topic: int
    detail: int
    tokens: np.ndarray        # (S,) int32 — BOS q … ANS_SEP answer EOS PAD…
    labels: np.ndarray        # (S,) int32 — next-token targets
    mask: np.ndarray          # (S,) float32 — 1 on answer positions
    image: Optional[np.ndarray] = None  # (M, frontend_dim) stub patch embeddings


@dataclass
class SyntheticVQA:
    """Corpus generator. ``task_id`` shifts all clusters/templates so distinct
    task_ids emulate distinct datasets (Tab. 5 cross-task setup)."""

    vocab_size: int
    seq_len: int = 32
    n_topics: int = 8
    n_answers: int = 16
    n_details: int = 4
    frontend_dim: int = 0     # 0 => text-only arch (no image stream)
    n_patches: int = 64
    noise: float = 0.35
    label_noise: float = 0.02
    task_id: int = 0

    def __post_init__(self):
        self.tok = ToyTokenizer(self.vocab_size, self.n_topics, self.n_answers)
        rng = np.random.RandomState(1234 + 17 * self.task_id)
        if self.frontend_dim:
            self.topic_mu = rng.randn(self.n_topics, self.frontend_dim).astype(np.float32)
            self.detail_dir = rng.randn(self.n_details, self.frontend_dim).astype(np.float32)

    def answer_of(self, topic: int, detail: int) -> int:
        return (topic * 3 + detail + 5 * self.task_id) % self.n_answers

    def gen_example(self, rng: np.random.RandomState, topic: int) -> Example:
        detail = rng.randint(self.n_details)
        ans = self.answer_of(topic, detail)
        if self.label_noise > 0 and rng.rand() < self.label_noise:
            ans = rng.randint(self.n_answers)

        q_len = rng.randint(4, max(5, self.seq_len - 8))
        fillers = [self.tok.filler_token(rng.randint(1 << 30)) for _ in range(q_len - 2)]
        q = [Q_START, self.tok.topic_token(topic)] + fillers + [Q_END]
        if self.frontend_dim == 0:
            # text-only: the detail must be textual or the task is unlearnable
            q.insert(2, self.tok.filler_token(1000003 + detail))

        seq = [BOS] + q + [ANS_SEP, self.tok.answer_token(ans), EOS]
        seq = seq[: self.seq_len]
        pad = self.seq_len - len(seq)
        tokens = np.array(seq + [PAD] * pad, np.int32)

        labels = np.concatenate([tokens[1:], [PAD]]).astype(np.int32)
        mask = np.zeros(self.seq_len, np.float32)
        # supervise the answer token (predicted from the ANS_SEP position)
        ans_pos = len(seq) - 3  # index of ANS_SEP in `tokens`
        if 0 <= ans_pos < self.seq_len:
            mask[ans_pos] = 1.0

        image = None
        if self.frontend_dim:
            base = self.topic_mu[topic] + 0.8 * self.detail_dir[detail]
            patches = base[None, :] + self.noise * rng.randn(
                self.n_patches, self.frontend_dim
            ).astype(np.float32)
            image = patches.astype(np.float32)
        return Example(topic=topic, detail=detail, tokens=tokens, labels=labels, mask=mask, image=image)

    def generate(self, n: int, topics: Optional[List[int]] = None, seed: int = 0) -> List[Example]:
        rng = np.random.RandomState(seed + 31 * self.task_id)
        out = []
        for i in range(n):
            t = topics[i % len(topics)] if topics else rng.randint(self.n_topics)
            out.append(self.gen_example(rng, t))
        return out
