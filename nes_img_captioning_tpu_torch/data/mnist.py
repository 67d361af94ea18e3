"""MNIST data (port of ``nes_img_captioning_tpu/data/mnist.py``, numpy only).

The reference uses torchvision's MNIST with Normalize((0.1307,), (0.3081,))
(reference: src/classification/experiment.py:16-24) and splits the official
test set into equal val/test halves
(src/algorithm/tools/experiment.py:92-96). The standard idx files are read
from ``<root>/MNIST/raw`` (or ``<root>``), gzipped or not; when they are
absent a small deterministic class-structured dataset is synthesized, the
same arrays as the JAX package's for the same seed and sizes, bit for bit.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["load_mnist", "MNIST_MEAN", "MNIST_STD"]

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zeros, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        assert zeros == 0 and dtype_code == 8, f"unsupported idx file {path}"
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(root: str, stem: str) -> str | None:
    for cand in (
        os.path.join(root, "MNIST", "raw", stem),
        os.path.join(root, "MNIST", "raw", stem + ".gz"),
        os.path.join(root, stem),
        os.path.join(root, stem + ".gz"),
    ):
        if os.path.isfile(cand):
            return cand
    return None


def _synthetic(n_train: int, n_test: int, seed: int = 0):
    """Deterministic 10-class toy digits: each class is a fixed smoothed
    blob pattern plus noise, learnable by the small CNN in a few
    generations."""
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, size=(10, 28, 28)).astype(np.float32)
    # smooth the prototypes so conv features are informative
    k = np.ones((5, 5)) / 25.0
    smoothed = np.stack([
        np.pad((sliding_window_view(p, (5, 5)) * k).sum(axis=(2, 3)), 2,
               mode="edge")
        for p in protos])

    def make(n, rng):
        labels = rng.integers(0, 10, size=n)
        imgs = smoothed[labels] + rng.normal(0, 32, size=(n, 28, 28))
        return np.clip(imgs, 0, 255).astype(np.uint8), labels.astype(np.int64)

    return make(n_train, rng) + make(n_test, rng)


def load_mnist(root: str = "./data", synthetic_sizes=(2048, 512),
               seed: int = 0) -> dict:
    """Normalized f32 arrays: train_x (N, 1, 28, 28), train_y, val_x, val_y,
    test_x, test_y (labels int32). Val and test are equal halves of the
    test set, split by a permutation seeded with ``seed`` (the reference's
    random_split is unseeded)."""
    paths = {k: _find(root, stem) for k, stem in _FILES.items()}
    if all(paths.values()):
        tr_x = _read_idx(paths["train_images"])
        tr_y = _read_idx(paths["train_labels"]).astype(np.int64)
        te_x = _read_idx(paths["test_images"])
        te_y = _read_idx(paths["test_labels"]).astype(np.int64)
    else:
        tr_x, tr_y, te_x, te_y = _synthetic(*synthetic_sizes, seed=seed)

    def norm(x):
        x = x.astype(np.float32) / 255.0
        return ((x - MNIST_MEAN) / MNIST_STD)[:, None, :, :]

    perm = np.random.default_rng(seed).permutation(len(te_y))
    half = len(te_y) // 2
    val_ix, test_ix = perm[:half], perm[half:]
    return {
        "train_x": norm(tr_x),
        "train_y": tr_y.astype(np.int32),
        "val_x": norm(te_x[val_ix]),
        "val_y": te_y[val_ix].astype(np.int32),
        "test_x": norm(te_x[test_ix]),
        "test_y": te_y[test_ix].astype(np.int32),
    }
