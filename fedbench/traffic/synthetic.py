"""Synthetic multimodal VQA corpus and its Dirichlet non-IID partition: the
benchmark's own copy of the port's ``data/synthetic.py``, ``data/partition.py``
and ``data/tokenizer.py``, so that a change to the program cannot move the
yardstick. Numpy only.

Each example is drawn from a latent topic: the topic sets the image stub's
patch cluster and a question keyword, and the answer is a function of the
topic and a per-example detail carried by the image and a question token.
One position per row is supervised: the answer, predicted at the answer
separator. ``question_tokens`` (min, max) bounds the question's length; the
port's generator draws it from [4, seq_len - 8), which is the default here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, BOS, EOS, Q_START, Q_END, ANS_SEP = 0, 1, 2, 3, 4, 5
TOPIC_BASE = 8
ANSWER_BASE = 40
FILLER_BASE = 64


@dataclass
class Example:
    topic: int
    detail: int
    tokens: np.ndarray        # (S,) int32: BOS question ANS_SEP answer EOS PAD...
    labels: np.ndarray        # (S,) int32: next-token targets
    mask: np.ndarray          # (S,) float32: 1 at the answer's position
    image: Optional[np.ndarray] = None  # (M, frontend_dim) stub patch embeddings


@dataclass
class SyntheticVQA:
    """Corpus generator; ``frontend_dim`` 0 makes a text-only corpus."""

    vocab_size: int
    seq_len: int = 32
    n_topics: int = 8
    n_answers: int = 16
    n_details: int = 4
    frontend_dim: int = 0
    n_patches: int = 64
    noise: float = 0.35
    label_noise: float = 0.02
    question_tokens: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        rng = np.random.RandomState(1234)
        if self.frontend_dim:
            self.topic_mu = rng.randn(self.n_topics, self.frontend_dim).astype(np.float32)
            self.detail_dir = rng.randn(self.n_details, self.frontend_dim).astype(np.float32)

    def filler(self, h: int) -> int:
        return FILLER_BASE + (h % max(self.vocab_size - FILLER_BASE, 1))

    def answer_of(self, topic: int, detail: int) -> int:
        return (topic * 3 + detail) % self.n_answers

    def gen_example(self, rng: np.random.RandomState, topic: int) -> Example:
        detail = rng.randint(self.n_details)
        ans = self.answer_of(topic, detail)
        if self.label_noise > 0 and rng.rand() < self.label_noise:
            ans = rng.randint(self.n_answers)

        lo, hi = self.question_tokens or (4, max(5, self.seq_len - 8))
        q_len = rng.randint(lo, hi)
        fillers = [self.filler(rng.randint(1 << 30)) for _ in range(q_len - 2)]
        q = [Q_START, TOPIC_BASE + topic % self.n_topics] + fillers + [Q_END]
        if self.frontend_dim == 0:
            # text only: the detail must be textual or the task is unlearnable
            q.insert(2, self.filler(1000003 + detail))

        seq = [BOS] + q + [ANS_SEP, ANSWER_BASE + ans % self.n_answers, EOS]
        seq = seq[: self.seq_len]
        tokens = np.array(seq + [PAD] * (self.seq_len - len(seq)), np.int32)
        labels = np.concatenate([tokens[1:], [PAD]]).astype(np.int32)
        mask = np.zeros(self.seq_len, np.float32)
        ans_pos = len(seq) - 3  # the answer separator, which predicts the answer
        if 0 <= ans_pos < self.seq_len:
            mask[ans_pos] = 1.0

        image = None
        if self.frontend_dim:
            base = self.topic_mu[topic] + 0.8 * self.detail_dir[detail]
            image = (base[None, :] + self.noise * rng.randn(
                self.n_patches, self.frontend_dim).astype(np.float32)).astype(np.float32)
        return Example(topic=topic, detail=detail, tokens=tokens, labels=labels, mask=mask,
                       image=image)

    def generate(self, n: int, seed: int) -> List[Example]:
        rng = np.random.RandomState(seed)
        return [self.gen_example(rng, rng.randint(self.n_topics)) for _ in range(n)]


def dirichlet_partition(items: Sequence, topics: Sequence[int], n_clients: int, alpha: float,
                        seed: int, min_per_client: int = 2) -> Dict[int, List]:
    """Split ``items`` over clients, each topic by a Dir(alpha) draw over the
    clients; then top every client up to ``min_per_client`` from the
    largest shards."""
    rng = np.random.RandomState(seed)
    topics = np.asarray(topics)
    shards: Dict[int, List] = {k: [] for k in range(n_clients)}
    for t in np.unique(topics):
        idx = np.where(topics == t)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(alpha * np.ones(n_clients))
        counts = np.floor(p * len(idx)).astype(int)
        while counts.sum() < len(idx):
            counts[rng.randint(n_clients)] += 1
        start = 0
        for k in range(n_clients):
            shards[k].extend(items[i] for i in idx[start:start + counts[k]])
            start += counts[k]
    donors = sorted(shards, key=lambda k: -len(shards[k]))
    for k in range(n_clients):
        while len(shards[k]) < min_per_client:
            d = donors[0]
            if len(shards[d]) <= min_per_client:
                break
            shards[k].append(shards[d].pop())
            donors = sorted(shards, key=lambda q: -len(shards[q]))
    for k in shards:
        rng.shuffle(shards[k])
    return shards


def client_batches(items: List[Example], rows: int) -> List[Dict[str, np.ndarray]]:
    """A client's examples as batches of ``rows``, the last filled by
    repeating its own examples."""
    out = []
    for i in range(0, len(items), rows):
        chunk = (items[i:i + rows] * rows)[:rows]
        b = {f: np.stack([getattr(e, f) for e in chunk]) for f in ("tokens", "labels", "mask")}
        if chunk[0].image is not None:
            b["patches"] = np.stack([e.image for e in chunk])
        out.append(b)
    return out
