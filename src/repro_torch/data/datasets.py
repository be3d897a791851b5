"""Data substrate (port of ``repro/data/datasets.py``): synthetic task
generators and the federated (non-IID) partitioner.

Every draw goes through an explicit CPU ``torch.Generator`` (or a NumPy
``Generator`` seeded from one), so the data, the split and the per-round
batches are the same whichever device the run uses.  The streams differ
from the JAX package's (threefry): parity tests hand JAX-made data across.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.rng import generator


# ---------------------------------------------------------------------------
# synthetic MNIST-like classification task (Case I)


def synthetic_mnist(gen: torch.Generator, num_examples: int,
                    num_classes: int = 10, side: int = 28,
                    noise: float = 0.35) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional images: each class is a fixed random smooth template
    plus per-example Gaussian noise.  Returns (x [n, side^2] fp32, labels
    [n] int64) on the CPU."""
    base = torch.randn((num_classes, side * side), generator=gen)
    tmpl = base.reshape(num_classes, side, side)
    for _ in range(2):   # 3x3 box blur with edge padding, twice
        pad = F.pad(tmpl[None], (1, 1, 1, 1), mode="replicate")[0]
        tmpl = sum(pad[:, i:i + side, j:j + side]
                   for i in range(3) for j in range(3)) / 9.0
    tmpl = tmpl.reshape(num_classes, side * side)
    labels = torch.randint(0, num_classes, (num_examples,), generator=gen)
    x = tmpl[labels] + noise * torch.randn((num_examples, side * side),
                                           generator=gen)
    return x, labels


# ---------------------------------------------------------------------------
# ridge regression task (Case II)


def ridge_data(gen: torch.Generator, num_examples: int, dim: int,
               noise: float = 0.05):
    w_true = torch.randn((dim,), generator=gen)
    x = torch.randn((num_examples, dim), generator=gen)
    y = x @ w_true + noise * torch.randn((num_examples,), generator=gen)
    return x, y, w_true


# ---------------------------------------------------------------------------
# synthetic token streams (the transformer train step's data)


def token_stream(gen: torch.Generator, num_sequences: int, seq_len: int,
                 vocab: int) -> torch.Tensor:
    """Markov-ish synthetic tokens, so that a loss can decrease: a random
    start in [0, vocab), then cumulative steps drawn in [0, 17), mod
    ``vocab``.  Returns [num_sequences, seq_len] int32 on the CPU."""
    start = torch.randint(0, vocab, (num_sequences, 1), generator=gen)
    steps = torch.randint(0, 17, (num_sequences, seq_len - 1), generator=gen)
    toks = torch.cumsum(torch.cat([start, steps], dim=1), dim=1) % vocab
    return toks.to(torch.int32)


# ---------------------------------------------------------------------------
# federated partitioner


@dataclasses.dataclass(frozen=True)
class FederatedSplit:
    """Per-device index sets (variable sizes => the paper's D_k weights)."""
    indices: Tuple[np.ndarray, ...]

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(i) for i in self.indices])

    def weights(self) -> np.ndarray:
        """The paper's D_k / D_A weights: each device's share of the
        examples."""
        s = self.sizes
        return s / s.sum()


def split_iid(gen: torch.Generator, num_examples: int,
              num_devices: int) -> FederatedSplit:
    perm = torch.randperm(num_examples, generator=gen).numpy()
    return FederatedSplit(tuple(np.sort(p)
                                for p in np.array_split(perm, num_devices)))


def split_dirichlet(gen: torch.Generator, labels: np.ndarray,
                    num_devices: int, alpha: float = 0.5) -> FederatedSplit:
    """Label-skewed non-IID split (Dirichlet over class proportions)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    rng = np.random.default_rng(seed)
    dev_idx: List[List[int]] = [[] for _ in range(num_devices)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_devices)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for d, part in enumerate(np.split(idx, cuts)):
            dev_idx[d].extend(part.tolist())
    # guarantee every device has at least one example
    for d in range(num_devices):
        if not dev_idx[d]:
            donor = int(np.argmax([len(x) for x in dev_idx]))
            dev_idx[d].append(dev_idx[donor].pop())
    return FederatedSplit(tuple(np.sort(np.array(d, dtype=np.int64))
                                for d in dev_idx))


def device_batches(seed: int, split: FederatedSplit, batch_size: int,
                   round_idx: int) -> np.ndarray:
    """[K, batch_size] example indices for one round: device k samples its
    shard uniformly with replacement, from a generator seeded by
    ``(seed, round_idx)`` so any round can be drawn on its own."""
    return device_batches_many(seed, split, batch_size, (round_idx,))[0]


def device_batches_many(seed: int, split: FederatedSplit, batch_size: int,
                        rounds: Sequence[int]) -> np.ndarray:
    """[T, K, batch_size] example indices for a chunk of rounds: row i is
    round ``rounds[i]``'s ``device_batches``, drawn from its own generator,
    and each device's shard is gathered once for the whole chunk (the
    compiled driver's data path)."""
    sizes = torch.as_tensor(split.sizes, dtype=torch.float64)
    u = torch.stack([torch.rand((len(split.indices), batch_size),
                                generator=generator(seed, t),
                                dtype=torch.float64) for t in rounds])
    choices = torch.minimum(torch.floor(u * sizes[:, None]),
                            sizes[:, None] - 1).long().numpy()
    return np.stack([idx[choices[:, d]] for d, idx in
                     enumerate(split.indices)], axis=1)
