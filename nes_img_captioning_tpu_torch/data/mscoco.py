"""Karpathy-split MSCOCO data (port of ``CocoData`` in ``nes_img_captioning_tpu/data/mscoco.py``).

On-disk contract (reference: src/captioning/dataloader.py): ``input_json``
{'ix_to_word', 'images': [{'split', 'id', 'file_path'}]},
``input_label_h5`` with 'labels' (M, seq_length) and 1-based
'label_start_ix' / 'label_end_ix', and ``input_fc_dir`` of per-image
'<id>.npy' features, consolidated on first load into '<dir>_fc.npy' (+
'_ids.npy'). 'restval' images join 'train' when train_only == 0. The label
file is read by ``data/hdf5.py`` with numpy alone; ``from_arrays`` builds
the same object from memory. ``CocoBatcher`` is the reference's ``get_batch``
API, and ``word_stem_of`` / ``word_syn_of`` / ``paraphrase_table`` /
``meteor_params`` map METEOR's user-supplied tables
(``caption_options.meteor_*``) into word-id space.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from .hdf5 import read_datasets

logger = logging.getLogger(__name__)

__all__ = ["CocoData", "CocoBatcher", "METEOR_OPTIONS"]

# the caption_options keys of METEOR's user-supplied tables
METEOR_OPTIONS = ("meteor_synonyms", "meteor_paraphrases", "meteor_params",
                  "meteor_function_words")


def read_feature_files(paths: list) -> np.ndarray:
    """``np.stack([np.load(p).astype(np.float32) for p in paths])`` with one
    open and read per file: a file whose ``.npy`` header is the first
    file's is cut from its bytes, any other goes through ``np.load``. Where
    each file-system call is slow, np.load's own calls and header parse
    were most of a first load (123,287 files: 0.42 ms against 0.17 ms a
    file on the H100 machine's)."""
    with open(paths[0], "rb") as f:
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                                 if version == (1, 0) else
                                 np.lib.format.read_array_header_2_0(f))
        head = f.tell()
        f.seek(0)
        header = f.read(head)
    fast = not fortran and not dtype.hasobject
    size = head + int(np.prod(shape)) * dtype.itemsize
    out = np.empty((len(paths), *shape), np.float32)
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            raw = f.read()
        if fast and len(raw) == size and raw[:head] == header:
            out[i] = np.frombuffer(raw, dtype, offset=head).reshape(shape)
            continue
        row = np.load(path)
        if row.shape != tuple(shape):
            raise ValueError(f"{path}: features of shape {row.shape}, the "
                             f"first file's {tuple(shape)}")
        out[i] = row
    return out


class CocoData:
    def __init__(self, opts: dict, train_only: int = 0):
        self.opts = opts
        with open(opts["input_json"]) as f:
            info = json.load(f)
        h5 = read_datasets(opts["input_label_h5"],
                           ("labels", "label_start_ix", "label_end_ix"))
        labels = np.asarray(h5["labels"], dtype=np.int32)
        start_ix = np.asarray(h5["label_start_ix"], dtype=np.int64)
        end_ix = np.asarray(h5["label_end_ix"], dtype=np.int64)
        self._setup(info, labels, start_ix, end_ix, train_only)
        self._fc = self._load_fc(opts["input_fc_dir"])

    @classmethod
    def from_arrays(cls, arrays: dict, train_only: int = 0,
                    opts: dict | None = None) -> "CocoData":
        """From in-memory arrays (data/synthetic.synthetic_coco_arrays
        layout): 'info', 'labels', 'label_start_ix', 'label_end_ix' and
        'feats' (N_images, F) in image order. ``opts``: the
        ``caption_options`` whose METEOR keys the table builders read (the
        file keys are not read)."""
        self = cls.__new__(cls)
        self.opts = dict(opts or {})
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
        feats = read_feature_files([os.path.join(fc_dir, f"{img['id']}.npy")
                                    for img in self.images])
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

    def get_captions(self, split_pos: int, split: str, seq_per_img: int,
                     rng) -> np.ndarray:
        """seq_per_img contiguous captions of one image (subsample with
        replacement when fewer exist — reference dataloader.py:115-133)."""
        ix = self.split_ix[split][split_pos]
        ix1, ix2 = self.label_start_ix[ix] - 1, self.label_end_ix[ix] - 1
        ncap = ix2 - ix1 + 1
        if ncap < seq_per_img:
            rows = [
                self.labels[rng.integers(ix1, ix2 + 1)] for _ in range(seq_per_img)
            ]
            return np.stack(rows)
        start = rng.integers(ix1, ix2 - seq_per_img + 2)
        return self.labels[start : start + seq_per_img]

    def batcher(self, split: str, batch_size: int, seq_per_img: int = 5,
                seed: int | None = 0) -> "CocoBatcher":
        return CocoBatcher(self, split, batch_size, seq_per_img, seed=seed)

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

    def _vocab_wids(self) -> np.ndarray:
        """Word-id (word_id_rows space) of every vocab token, vectorized:
        ``_vocab_wids()[t - 1]`` is token t's word-id. Shared by the METEOR
        table builders below."""
        if not hasattr(self, "_vocab_wid_arr"):
            self._vocab_wid_arr = self.word_id_rows(
                np.arange(1, self.vocab_size + 1))
        return self._vocab_wid_arr

    def word_stem_of(self, word_id: int) -> int:
        """Word-id (from word_id_rows) -> Porter-stem-class id, for METEOR's
        stem matcher (language_eval). Built once from the vocab strings."""
        if not hasattr(self, "_word_stem_table"):
            from ..fitness.meteor import porter_stem

            wids = self._vocab_wids()
            word_of: dict[int, str] = {}
            for t in range(1, self.vocab_size + 1):
                word_of.setdefault(int(wids[t - 1]), self.ix_to_word[str(t)])
            stem_ids: dict[str, int] = {}
            table = np.zeros(max(word_of, default=0) + 1, np.int32)
            for wid, w in word_of.items():
                s = porter_stem(w.lower())
                table[wid] = stem_ids.setdefault(s, len(stem_ids) + 1)
            self._word_stem_table = table
        return int(self._word_stem_table[word_id])

    def word_syn_of(self, word_id: int):
        """Word-id (from word_id_rows) -> synonym-class-id frozenset (or
        None), for METEOR's optional stage-3 synonym matcher. Backed by a
        user-supplied table (``caption_options.meteor_synonyms`` — a JSON
        path, see fitness/meteor.load_synonym_table); returns None for every
        word when no table is configured, keeping the exact+stem behavior.
        Restores the reference Java METEOR-1.5's WordNet matcher given
        equivalent data (reference: src/captioning/eval_utils.py:30-57)."""
        if not hasattr(self, "_word_syn_table"):
            path = self.opts.get("meteor_synonyms")
            if not path:
                self._word_syn_table = {}
            else:
                from ..fitness.meteor import load_synonym_table

                syn = load_synonym_table(path)
                wids = self._vocab_wids()
                table: dict[int, frozenset] = {}
                for t in range(1, self.vocab_size + 1):
                    s = syn.get(self.ix_to_word[str(t)].lower())
                    if s:
                        table.setdefault(int(wids[t - 1]), s)
                self._word_syn_table = table
        return self._word_syn_table.get(word_id)

    def has_synonym_table(self) -> bool:
        return bool(self.opts.get("meteor_synonyms"))

    def paraphrase_table(self):
        """Word-id-space ParaphraseTable (or None) for METEOR's optional
        stage-4 phrase matcher, from a user-supplied table
        (``caption_options.meteor_paraphrases`` — a JSON path, see
        fitness/meteor.load_paraphrase_table). Phrases containing
        out-of-vocab words are dropped (they can never appear in a decoded
        or reference caption); string phrases that collapse to the same
        word-id tuple merge their class sets. Restores the reference Java
        METEOR-1.5's paraphrase stage given equivalent data (reference:
        src/captioning/eval_utils.py:30-57)."""
        if not hasattr(self, "_para_table"):
            path = self.opts.get("meteor_paraphrases")
            if not path:
                self._para_table = None
            else:
                from ..fitness.meteor import (
                    ParaphraseTable,
                    load_paraphrase_table,
                )

                import itertools

                ptab = load_paraphrase_table(path)
                # Lowercased word -> every case-variant word-id, so a
                # phrase keyed "car" matches captions using "Car" too
                # (mirrors word_syn_of, which maps every variant).
                wids_of: dict[str, set] = {}
                wids = self._vocab_wids()
                for t in range(1, self.vocab_size + 1):
                    w = self.ix_to_word[str(t)].lower()
                    wids_of.setdefault(w, set()).add(int(wids[t - 1]))
                table: dict[tuple, frozenset] = {}
                n_trunc = 0
                for phrase, cls in ptab.table.items():
                    variants = [sorted(wids_of.get(w, ())) for w in phrase]
                    if any(not v for v in variants):
                        continue  # out-of-vocab word: phrase can't appear
                    n_combo = 1
                    for v in variants:
                        n_combo *= len(v)
                    # real vocabs have <=2-3 case variants per word and
                    # METEOR phrases are short, so 64 combos is generous;
                    # don't truncate silently if a vocab defeats that
                    n_trunc += n_combo > 64
                    combos = itertools.islice(
                        itertools.product(*variants), 64)
                    for ids in combos:
                        table[ids] = table.get(ids, frozenset()) | cls
                if n_trunc:
                    import logging

                    logging.getLogger(__name__).warning(
                        "paraphrase_table: %d phrases had >64 case-variant "
                        "combinations; extras were dropped", n_trunc)
                self._para_table = ParaphraseTable(table)
        return self._para_table

    def meteor_params(self):
        """fitness.meteor.Meteor15Params (or None) switching METEOR scoring
        to the 1.5 formulation, from ``caption_options.meteor_params`` —
        ``true`` / ``"1.5"`` for the tuned English defaults, or a dict
        overriding any of alpha/beta/gamma/delta/weights. A
        ``caption_options.meteor_function_words`` list (JSON or one word per
        line, see fitness/meteor.load_function_words) enables the δ
        function-word weighting, mapped into word-id space here (every case
        variant of a listed word counts as a function word). Restores the
        reference Java METEOR-1.5's scoring given its data exports
        (reference: src/captioning/eval_utils.py:30-57)."""
        if not hasattr(self, "_meteor_params"):
            spec = self.opts.get("meteor_params")
            if not spec:
                self._meteor_params = None
            else:
                from ..fitness.meteor import (
                    Meteor15Params,
                    load_function_words,
                )

                kw = dict(spec) if isinstance(spec, dict) else {}
                fw_path = self.opts.get("meteor_function_words")
                if fw_path:
                    fwords = load_function_words(fw_path)
                    wids = self._vocab_wids()
                    is_func = np.zeros(int(wids.max()) + 1, bool)
                    for t in range(1, self.vocab_size + 1):
                        if self.ix_to_word[str(t)].lower() in fwords:
                            is_func[int(wids[t - 1])] = True
                    kw["func_of"] = lambda wid: bool(
                        0 <= wid < is_func.size and is_func[wid])
                self._meteor_params = Meteor15Params(**kw)
        return self._meteor_params

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


class CocoBatcher:
    """Reference-shaped batch API for drop-in compatibility.

    Produces the exact ``get_batch`` dict of the reference dataloader
    (src/captioning/dataloader.py:139-203): ``fc_feats`` with every image's
    features repeated seq_per_img x, ``labels`` (B*spi, seq_length+2) with
    captions in columns 1..seq_length, ``gts`` (all reference captions per
    image), ``bounds`` {it_pos_now, it_max, wrapped} and ``infos``; shuffled
    per epoch for the train split (BlobFetcher shuffle-on-wrap). The training
    path does not use this (it gathers on the device); this class exists for
    users porting reference code and for offline tooling.
    """

    def __init__(self, data: CocoData, split: str, batch_size: int,
                 seq_per_img: int = 5, seed: int | None = 0):
        self.data = data
        self.split = split
        self.batch_size = batch_size
        self.seq_per_img = seq_per_img
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(data.split_len(split))
        if split == "train":
            self._rng.shuffle(self._order)
        self._pos = 0
        self._feats = data.split_feats(split)

    def reset_iterator(self):
        self._pos = 0
        if self.split == "train":
            self._rng.shuffle(self._order)

    def get_batch(self, batch_size: int | None = None,
                  seq_per_img: int | None = None) -> dict:
        bs = batch_size or self.batch_size
        spi = seq_per_img or self.seq_per_img
        d = self.data
        n = d.split_len(self.split)
        seq_len = d.seq_length

        fc, labels, gts, infos = [], [], [], []
        wrapped = False
        for _ in range(bs):
            if self._pos >= n:
                self._pos = 0
                wrapped = True
                if self.split == "train":
                    self._rng.shuffle(self._order)
            pos = self._order[self._pos]
            self._pos += 1
            ix = d.split_ix[self.split][pos]

            fc.append(self._feats[pos])
            caps = d.get_captions(pos, self.split, spi, self._rng)
            lab = np.zeros((spi, seq_len + 2), dtype=np.int64)
            lab[:, 1 : seq_len + 1] = caps
            labels.append(lab)
            s, e = d.label_start_ix[ix] - 1, d.label_end_ix[ix]
            gts.append(d.labels[s:e])
            infos.append({
                "ix": int(ix),
                "id": d.images[ix]["id"],
                "file_path": d.images[ix].get("file_path", ""),
            })

        return {
            "fc_feats": np.repeat(np.stack(fc), spi, axis=0),
            "labels": np.concatenate(labels, axis=0),
            "gts": tuple(gts),
            "bounds": {"it_pos_now": self._pos, "it_max": n, "wrapped": wrapped},
            "infos": infos,
        }

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        # infinite, like the reference wrapper (captioning/experiment.py:74-76)
        return self.get_batch()

    def __len__(self) -> int:
        return self.data.split_len(self.split) // self.batch_size
