"""Batching pipeline of the port: Examples -> ``Batch``es of tensors on a device
(``repro.data.pipeline``), per-client train/eval shards.

The corpus and the partition are numpy and draw from the JAX package's
seeds, so the batches equal the JAX package's element for element. Tokens
and labels are int64 (PyTorch's index type), the mask and patches float32.
Batches are built once and reused across rounds.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.types import Batch
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import Example, SyntheticVQA
from repro_torch.models.vision_stub import num_patches


def examples_to_batches(examples: List[Example], batch_size: int, *, device="cuda",
                        drop_remainder: bool = False) -> List[Batch]:
    out = []
    n = len(examples)
    for i in range(0, n, batch_size):
        chunk = examples[i : i + batch_size]
        if len(chunk) < batch_size:
            if drop_remainder and out:
                break
            # pad by repeating, as the JAX pipeline does
            chunk = chunk + chunk[: batch_size - len(chunk)]

        def stack(field, dtype):
            return torch.from_numpy(np.stack([getattr(e, field) for e in chunk])).to(
                device=device, dtype=dtype)

        patches = stack("image", torch.float32) if chunk[0].image is not None else None
        out.append(Batch(tokens=stack("tokens", torch.long), labels=stack("labels", torch.long),
                         mask=stack("mask", torch.float32), patches=patches))
    return out


def make_federated_data(
    cfg,
    *,
    n_clients: int = 5,
    examples_per_client: int = 64,
    alpha: float = 1.0,
    batch_size: int = 8,
    seq_len: int = 32,
    seed: int = 0,
    task_id: int = 0,
    eval_frac: float = 0.25,
    device="cuda",
) -> Tuple[Dict[int, List[Batch]], Dict[int, List[Batch]], SyntheticVQA]:
    """Generate + Dirichlet-partition a synthetic VQA corpus for ``cfg``.

    Returns (train_batches, eval_batches, corpus), the batches on ``device``.
    """
    gen = SyntheticVQA(
        vocab_size=cfg.vocab_size,
        seq_len=seq_len,
        frontend_dim=cfg.frontend_dim,
        n_patches=num_patches(cfg) if cfg.frontend_dim else 0,
        task_id=task_id,
    )
    examples = gen.generate(n_clients * examples_per_client, seed=seed)
    shards = dirichlet_partition(
        examples, [e.topic for e in examples], n_clients, alpha, seed=seed,
        min_per_client=max(2 * batch_size, 8),
    )
    train, evald = {}, {}
    for k, items in shards.items():
        n_eval = max(int(len(items) * eval_frac), 1)
        evald[k] = examples_to_batches(items[:n_eval], batch_size, device=device)
        train[k] = examples_to_batches(items[n_eval:], batch_size, device=device)
    return train, evald, gen
