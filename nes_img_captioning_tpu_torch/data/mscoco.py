"""Karpathy-split MSCOCO data (port of ``CocoData`` in ``nes_img_captioning_tpu/data/mscoco.py``).

On-disk contract (reference: src/captioning/dataloader.py): ``input_json``
{'ix_to_word', 'images': [{'split', 'id', 'file_path'}]},
``input_label_h5`` with 'labels' (M, seq_length) and 1-based
'label_start_ix' / 'label_end_ix', and ``input_fc_dir`` of per-image
'<id>.npy' features, consolidated on first load into '<dir>_fc.npy' (+
'_ids.npy'). 'restval' images join 'train' when train_only == 0. ``h5py``
is imported only to read a label file on disk; ``from_arrays`` builds the
same object from memory.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["CocoData"]


class CocoData:
    def __init__(self, opts: dict, train_only: int = 0):
        with open(opts["input_json"]) as f:
            info = json.load(f)
        import h5py

        with h5py.File(opts["input_label_h5"], "r") as h5:
            labels = np.asarray(h5["labels"], dtype=np.int32)
            start_ix = np.asarray(h5["label_start_ix"], dtype=np.int64)
            end_ix = np.asarray(h5["label_end_ix"], dtype=np.int64)
        self._setup(info, labels, start_ix, end_ix, train_only)
        self._fc = self._load_fc(opts["input_fc_dir"])

    @classmethod
    def from_arrays(cls, arrays: dict, train_only: int = 0) -> "CocoData":
        """From in-memory arrays (data/synthetic.synthetic_coco_arrays
        layout): 'info', 'labels', 'label_start_ix', 'label_end_ix' and
        'feats' (N_images, F) in image order."""
        self = cls.__new__(cls)
        self._setup(arrays["info"], np.asarray(arrays["labels"], np.int32),
                    np.asarray(arrays["label_start_ix"], np.int64),
                    np.asarray(arrays["label_end_ix"], np.int64), train_only)
        self._fc = np.asarray(arrays["feats"], np.float32)
        return self

    def _setup(self, info, labels, start_ix, end_ix, train_only):
        self.ix_to_word = info["ix_to_word"]
        self.vocab_size = len(self.ix_to_word)
        self.images = info["images"]
        self.labels, self.label_start_ix, self.label_end_ix = (
            labels, start_ix, end_ix)
        self.seq_length = self.labels.shape[1]
        self.split_ix = {"train": [], "val": [], "test": []}
        for ix, img in enumerate(self.images):
            split = img["split"]
            if split in self.split_ix:
                self.split_ix[split].append(ix)
            elif train_only == 0:  # restval
                self.split_ix["train"].append(ix)
        for k, v in self.split_ix.items():
            logger.info("assigned %d images to split %s", len(v), k)

    def _load_fc(self, fc_dir: str) -> np.ndarray:
        """(N_images, feat_dim) f32, ordered like self.images."""
        cache_feats = fc_dir.rstrip("/") + "_fc.npy"
        cache_ids = fc_dir.rstrip("/") + "_ids.npy"
        ids = np.asarray([img["id"] for img in self.images], dtype=np.int64)
        if os.path.isfile(cache_feats) and os.path.isfile(cache_ids):
            if np.array_equal(np.load(cache_ids), ids):
                return np.load(cache_feats, mmap_mode="r")
        feats = np.stack([
            np.load(os.path.join(fc_dir, f"{img['id']}.npy")).astype(
                np.float32) for img in self.images])
        try:
            np.save(cache_feats, feats)
            np.save(cache_ids, ids)
        except OSError:
            pass  # read-only data dir: skip the consolidation cache
        return feats

    # ---- per-split views ----------------------------------------------------------

    def split_feats(self, split: str) -> np.ndarray:
        return np.ascontiguousarray(self._fc[self.split_ix[split]])

    def split_gts(self, split: str) -> list:
        """Per image of the split: (M_i, seq_length) int32 array of all its
        reference captions (reference dataloader.py:166-167)."""
        out = []
        for ix in self.split_ix[split]:
            s, e = self.label_start_ix[ix] - 1, self.label_end_ix[ix]
            out.append(self.labels[s:e])
        return out

    def split_len(self, split: str) -> int:
        return len(self.split_ix[split])

    def split_image_ids(self, split: str) -> list:
        return [self.images[ix]["id"] for ix in self.split_ix[split]]

    def word_id_rows(self, seq: np.ndarray) -> np.ndarray:
        """Token-id rows -> WORD-id rows: distinct vocabulary ids that map to
        the same word string (e.g. an UNK token) collapse to one id, exactly
        as pycocoevalcap's word-string scoring would merge them; 0 stays the
        sentence terminator. Reference convention:
        src/captioning/eval_utils.py:30-57."""
        if not hasattr(self, "_tok_to_word_id"):
            word_ids: dict[str, int] = {}
            table = np.zeros(self.vocab_size + 1, np.int32)
            for t in range(1, self.vocab_size + 1):
                w = self.ix_to_word[str(t)]
                table[t] = word_ids.setdefault(w, len(word_ids) + 1)
            self._tok_to_word_id = table
        seq = np.asarray(seq)
        return self._tok_to_word_id[np.clip(seq, 0, self.vocab_size)]

    def split_gts_words(self, split: str) -> list:
        """Per-image reference captions as word-id rows (for word-level
        validation scoring)."""
        return [self.word_id_rows(g) for g in self.split_gts(split)]

    def decode_sequence(self, seq: np.ndarray) -> list[str]:
        """Token rows -> sentences; stops at the first 0
        (reference: src/captioning/eval_utils.py:13-27)."""
        out = []
        for row in np.asarray(seq):
            words = []
            for t in row:
                if t <= 0:
                    break
                words.append(self.ix_to_word[str(int(t))])
            out.append(" ".join(words))
        return out
