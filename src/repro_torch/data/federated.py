"""Non-IID federated partitioning (LEAF-style client shards).

A copy of ``repro/data/federated.py`` (numpy only): same seeds, same shards.

The paper partitions CelebA by celebrity identity (each user holds 1-32
images of one person) with an 80/10/10 user split, seed 1549775860. We
reproduce the *statistical shape*: clients draw a per-client label
distribution from Dirichlet(alpha) and a sample count uniform in [1, 32],
then sample (with replacement if a shard is exhausted) from the synthetic
pool. 80/10/10 of CLIENTS (not samples) go to train/val/test, as in LEAF.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        min_samples: int, max_samples: int,
                        seed: int) -> List[np.ndarray]:
    """Return per-client index arrays with Dirichlet(alpha) label skew."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idxs in by_class:
        rng.shuffle(idxs)
    cursors = [0] * n_classes
    shards = []
    for _ in range(n_clients):
        n_i = int(rng.integers(min_samples, max_samples + 1))
        p = rng.dirichlet(np.full(n_classes, alpha))
        counts = rng.multinomial(n_i, p)
        take = []
        for c, k in enumerate(counts):
            pool = by_class[c]
            if cursors[c] + k <= len(pool):
                take.append(pool[cursors[c]: cursors[c] + k])
                cursors[c] += k
            else:  # exhausted: sample with replacement
                take.append(rng.choice(pool, size=k, replace=True))
        shards.append(np.concatenate(take) if take else np.array([], np.int64))
    return shards


@dataclasses.dataclass
class FederatedPartition:
    """Client shards + LEAF-style 80/10/10 user split over a dataset."""

    labels: np.ndarray
    n_clients: int = 1000
    alpha: float = 0.5
    min_samples: int = 1
    max_samples: int = 32
    seed: int = 1549775860

    def __post_init__(self):
        self.shards = dirichlet_partition(
            self.labels, self.n_clients, self.alpha,
            self.min_samples, self.max_samples, self.seed)
        rng = np.random.default_rng(self.seed + 1)
        order = rng.permutation(self.n_clients)
        n_tr = int(0.8 * self.n_clients)
        n_va = int(0.1 * self.n_clients)
        self.train_clients = order[:n_tr]
        self.val_clients = order[n_tr: n_tr + n_va]
        self.test_clients = order[n_tr + n_va:]

    def client_indices(self, client_id: int) -> np.ndarray:
        return self.shards[client_id % self.n_clients]

    def client_batch(self, dataset, client_id: int, batch_size: int,
                     rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = self.client_indices(client_id)
        if len(idx) == 0:
            idx = np.array([0])
        pick = rng.choice(idx, size=batch_size, replace=len(idx) < batch_size)
        return dataset.batch(pick)

    def split_indices(self, clients: np.ndarray) -> np.ndarray:
        parts = [self.shards[c] for c in clients if len(self.shards[c])]
        return np.concatenate(parts) if parts else np.array([], np.int64)
