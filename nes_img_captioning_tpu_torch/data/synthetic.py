"""Synthetic MSCOCO-format fixture (port of ``nes_img_captioning_tpu/data/synthetic.py``).

``synthetic_coco_arrays`` draws the same numbers in the same order as the
JAX package's ``make_synthetic_coco`` and returns them in memory, from
which ``CocoData.from_arrays`` builds a ``CocoData`` directly.
``write_synthetic_coco`` writes them in the on-disk contract (cocotalk.json
/ cocotalk_label.h5 through ``data/hdf5.write_datasets`` / per-image fc
.npy). Each image's feature vector encodes its caption's tokens, so
evolution can improve CIDEr.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np

from .hdf5 import write_datasets

__all__ = ["synthetic_coco_arrays", "write_synthetic_coco"]


def synthetic_coco_arrays(n_train: int = 64, n_val: int = 16,
                          n_test: int = 16, vocab_size: int = 30,
                          seq_length: int = 16, fc_feat_size: int = 64,
                          caps_per_img: int = 5, cap_len: int = 4,
                          seed: int = 0) -> dict:
    """{'info': cocotalk.json dict, 'labels' (N*caps, seq_length) int32,
    'label_start_ix'/'label_end_ix' (N,) 1-based, 'feats' (N, F) f32,
    'ids' (N,)} in image order."""
    rng = np.random.default_rng(seed)
    n = n_train + n_val + n_test
    splits = ["train"] * n_train + ["val"] * n_val + ["test"] * n_test

    ix_to_word = {str(i): f"w{i}" for i in range(1, vocab_size + 1)}
    images, labels, start_ix, end_ix, feats = [], [], [], [], []
    # token embedding that also generates the image features
    tok_proj = rng.normal(size=(vocab_size + 1, fc_feat_size)).astype(
        np.float32)

    row = 1  # h5 ranges are 1-based
    for i in range(n):
        img_id = 1000 + i
        images.append({"id": img_id, "split": splits[i],
                       "file_path": f"im/{img_id}.jpg"})
        base = rng.integers(1, vocab_size + 1, size=cap_len)
        caps = []
        for _ in range(caps_per_img):
            cap = base.copy()
            # small paraphrase noise on one position
            j = rng.integers(0, cap_len)
            if rng.random() < 0.3:
                cap[j] = rng.integers(1, vocab_size + 1)
            padded = np.zeros(seq_length, np.int32)
            padded[:cap_len] = cap
            caps.append(padded)
        labels.extend(caps)
        start_ix.append(row)
        end_ix.append(row + caps_per_img - 1)
        row += caps_per_img
        feat = tok_proj[base].sum(0) + 0.1 * rng.normal(size=fc_feat_size)
        feats.append(feat.astype(np.float32))

    return {
        "info": {"ix_to_word": ix_to_word, "images": images},
        "labels": np.stack(labels),
        "label_start_ix": np.asarray(start_ix),
        "label_end_ix": np.asarray(end_ix),
        "feats": np.stack(feats),
        "ids": np.asarray([im["id"] for im in images]),
    }


def write_synthetic_coco(out_dir: str, arrays: dict) -> dict:
    """Write ``synthetic_coco_arrays`` output in the on-disk contract;
    returns the caption_options dict pointing at the files."""
    os.makedirs(out_dir, exist_ok=True)
    fc_dir = os.path.join(out_dir, "fc")
    os.makedirs(fc_dir, exist_ok=True)
    # np.save's bytes in one write per file: every row has the first's
    # header (np.save's calls cost most of the write where each
    # file-system call is slow)
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, np.lib.format.header_data_from_array_1_0(arrays["feats"][0]))
    for img_id, feat in zip(arrays["ids"], arrays["feats"]):
        with open(os.path.join(fc_dir, f"{int(img_id)}.npy"), "wb") as f:
            f.write(head.getvalue() + np.ascontiguousarray(feat).tobytes())
    input_json = os.path.join(out_dir, "cocotalk.json")
    with open(input_json, "w") as f:
        json.dump(arrays["info"], f)
    input_h5 = os.path.join(out_dir, "cocotalk_label.h5")
    write_datasets(input_h5, {k: arrays[k] for k in (
        "labels", "label_start_ix", "label_end_ix")})
    return {"input_json": input_json, "input_label_h5": input_h5,
            "input_fc_dir": fc_dir}

