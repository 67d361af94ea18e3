"""The captioning data of a cell, made from the run's seed.

The layout is the one ``CocoData.from_arrays`` reads (``info``, ``labels``,
``label_start_ix``, ``label_end_ix``, ``feats``, ``ids``), at the sizes the
workload file gives: the Karpathy split of MSCOCO (train, restval, val,
test images), a vocabulary of ``vocab_size`` words, ``caps_per_img``
references of ``cap_len`` words per image, padded with 0 to
``seq_length``. Each image draws ``cap_len`` words uniformly; each of its
references changes one of them with probability ``paraphrase``; its
feature vector is the sum of its words' rows of a random projection plus
Gaussian noise of ``feat_noise``, so a captioner can learn to name the
words. The draws are vectorised and run on ``device`` from one
``torch.Generator``: the same seed on the same device gives the same
arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_arrays", "split_rows"]

SPLITS = ("train", "restval", "val", "test")


def make_arrays(sizes: dict, vocab_size: int, feat_size: int,
                seq_length: int, seed: int, device) -> dict:
    """The arrays of one run. ``sizes``: the workload's ``data`` entry
    (image counts per split, ``cap_len``, ``caps_per_img``, ``paraphrase``,
    ``feat_noise``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_split = [int(sizes[s]) for s in SPLITS]
    n = sum(n_split)
    caps, cap_len = int(sizes["caps_per_img"]), int(sizes["cap_len"])

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device)

    proj = torch.randn((vocab_size + 1, feat_size), generator=gen,
                       device=device)
    words = randint(1, vocab_size + 1, (n, cap_len))
    refs = words[:, None, :].repeat(1, caps, 1)
    pos = randint(0, cap_len, (n, caps, 1))
    swap = torch.rand((n, caps, 1), generator=gen, device=device) \
        < float(sizes["paraphrase"])
    other = randint(1, vocab_size + 1, (n, caps, 1))
    cur = refs.gather(2, pos)
    refs.scatter_(2, pos, torch.where(swap, other, cur))
    labels = torch.zeros((n * caps, seq_length), dtype=torch.int32,
                         device=device)
    labels[:, :cap_len] = refs.reshape(n * caps, cap_len)
    feats = torch.nn.functional.embedding_bag(words, proj, mode="sum")
    feats += float(sizes["feat_noise"]) * torch.randn(
        feats.shape, generator=gen, device=device)

    # the restval images lie among the train block's, which they join
    split = np.repeat(np.array(["train", "val", "test"]),
                      [n_split[0] + n_split[1], n_split[2], n_split[3]])
    restval = torch.randperm(n_split[0] + n_split[1], generator=gen,
                             device=device)[:n_split[1]].cpu().numpy()
    split = split.astype(object)
    split[restval] = "restval"
    ids = np.arange(1000, 1000 + n)
    images = [{"id": int(i), "split": s, "file_path": f"im/{int(i)}.jpg"}
              for i, s in zip(ids, split)]
    start = np.arange(n, dtype=np.int64) * caps + 1
    return {
        "info": {"ix_to_word": {str(i): f"w{i}"
                                for i in range(1, vocab_size + 1)},
                 "images": images},
        "labels": labels.cpu().numpy(),
        "label_start_ix": start,
        "label_end_ix": start + caps - 1,
        "feats": feats.cpu().numpy(),
        "ids": ids,
    }


def split_rows(arrays: dict) -> dict:
    """{split: image rows in image order}, restval joined to train: the
    split rule of the reference's loader (restval trains)."""
    out = {"train": [], "val": [], "test": []}
    for i, img in enumerate(arrays["info"]["images"]):
        out["train" if img["split"] == "restval" else img["split"]].append(i)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}
