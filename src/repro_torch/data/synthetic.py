"""Deterministic synthetic classification data (MNIST-like) + federated
partitioners.

The paper's MNIST / Fashion-MNIST runs use a seeded synthetic substitute,
which needs no download: each class c has a structured 784-dim template
(low-frequency "stroke" pattern) and samples are template + elastic jitter +
Gaussian noise.  The task is learnable by the paper's shallow nets but not
trivial, so accuracy *orderings* across FL schemes reproduce.

The port's copy of ``repro.data.synthetic`` (numpy only): the same
generator calls in the same order, so every array equals the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["SyntheticImageData", "make_dataset", "partition_iid",
           "partition_dirichlet"]


@dataclasses.dataclass
class SyntheticImageData:
    x_train: np.ndarray        # (N, dim) float32 in [0, 1]-ish
    y_train: np.ndarray        # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def dim(self) -> int:
        return self.x_train.shape[1]


def _class_templates(rng: np.random.Generator, num_classes: int,
                     side: int) -> np.ndarray:
    """Low-frequency structured templates: random superpositions of 2-D
    Gabor-ish waves, one per class."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64) / side
    templates = np.zeros((num_classes, side * side))
    for c in range(num_classes):
        img = np.zeros((side, side))
        for _ in range(4):
            fx, fy = rng.uniform(1.0, 4.0, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.5, 1.0)
            img += amp * np.sin(2 * np.pi * fx * xx + px) \
                * np.sin(2 * np.pi * fy * yy + py)
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        templates[c] = img.reshape(-1)
    return templates


def make_dataset(num_train: int = 2000, num_test: int = 500,
                 num_classes: int = 10, side: int = 28,
                 noise: float = 0.35, seed: int = 0) -> SyntheticImageData:
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, num_classes, side)

    def sample(n):
        y = rng.integers(0, num_classes, size=n)
        shift = rng.normal(0.0, 0.15, size=(n, 1))        # brightness jitter
        scale = rng.uniform(0.8, 1.2, size=(n, 1))        # contrast jitter
        x = templates[y] * scale + shift \
            + rng.normal(0.0, noise, size=(n, templates.shape[1]))
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(num_train)
    x_te, y_te = sample(num_test)
    return SyntheticImageData(x_tr, y_tr, x_te, y_te, num_classes)


def partition_iid(num_samples_per_client: list[int], data: SyntheticImageData,
                  seed: int = 0) -> list[np.ndarray]:
    """IID partition: client i gets K_i uniformly sampled indices."""
    rng = np.random.default_rng(seed)
    total = sum(num_samples_per_client)
    if total > data.x_train.shape[0]:
        raise ValueError("not enough training samples to partition")
    perm = rng.permutation(data.x_train.shape[0])
    out, ofs = [], 0
    for k in num_samples_per_client:
        out.append(perm[ofs:ofs + k])
        ofs += k
    return out


def partition_dirichlet(num_samples_per_client: list[int],
                        data: SyntheticImageData, alpha: float = 0.5,
                        seed: int = 0) -> list[np.ndarray]:
    """Non-IID partition: per-client class mixture ~ Dirichlet(alpha)."""
    rng = np.random.default_rng(seed)
    by_class = [np.flatnonzero(data.y_train == c)
                for c in range(data.num_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    cursors = np.zeros(data.num_classes, dtype=np.int64)
    out = []
    for k in num_samples_per_client:
        mix = rng.dirichlet(np.full(data.num_classes, alpha))
        counts = rng.multinomial(k, mix)
        idxs = []
        for c, cnt in enumerate(counts):
            take = by_class[c][cursors[c]:cursors[c] + cnt]
            cursors[c] += len(take)
            idxs.append(take)
        idx = np.concatenate(idxs)
        if len(idx) < k:  # exhausted some class: fill from the global pool
            pool = rng.integers(0, data.x_train.shape[0], size=k - len(idx))
            idx = np.concatenate([idx, pool])
        out.append(idx.astype(np.int64))
    return out
