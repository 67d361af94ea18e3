"""CIDEr-D / CIDEr scorer over integer token sequences.

A numpy-only copy of ``nes_img_captioning_tpu/fitness/ciderd.py`` (the port
imports nothing of the JAX package): the host oracle and DF builder that
``ops/cider_device.py`` is held to.

The reference scores captions through the `cider` submodule's
``CiderD(df='coco-train-idxs').compute_score(gts, res)``
(reference: src/captioning/policies.py:19,72,180), converting token-id arrays
to whitespace strings first (``array_to_str``, src/algorithm/tools/utils.py:
34-40) — note the terminating 0 token IS included in the string, so the EOS
symbol participates in the n-gram statistics; we reproduce that exactly by
keeping tokens up to and including the first 0.

This implementation works directly on int32 token arrays (no string round
trip — the id↔word mapping is bijective so n-gram statistics are identical)
and is written from the published CIDEr-D definition (Vedantam et al. 2015,
consensus-based image description evaluation; -D variant: candidate n-gram
counts clipped to reference counts + gaussian length penalty, sigma = 6):

  g_n(s)[k]    = tf_k(s) * idf_k,   idf_k = ref_len - log(max(df_k, 1))
  val_n(c, r)  = sum_k min(g_n(c)[k], g_n(r)[k]) * g_n(r)[k]
                   / (||g_n(c)|| * ||g_n(r)||)       (clip: CIDEr-D only)
  pen(c, r)    = exp(-(len_c - len_r)^2 / (2 sigma^2))   (CIDEr-D only)
  score(c)     = 10 * mean_n ( (1/M) sum_r val_n(c, r) * pen(c, r) )

Document frequencies: the reference uses a frozen DF table computed over the
MSCOCO train captions ('coco-train-idxs'); ``fit_df`` rebuilds the equivalent
table from the training ground-truths (df counts the number of *images* whose
reference set contains the n-gram; ref_len = log(#images)). ``corpus`` mode
(df computed over the refs being scored) matches pycocoevalcap's behavior for
validation scoring.

Scale note: the reference's frozen table bakes in its own ref_len constant,
so absolute CIDEr-D *fitness* values from a rebuilt table differ from the
reference's by an (approximately) constant idf scale. This is benign for
training equivalence: NIC-NES uses centered RANKS of the fitnesses (invariant
under monotone transforms) and NIC-ES selects by SORTING them — the evolution
trajectory statistics are unaffected. Validation/test CIDEr (corpus mode)
follows the pycocoevalcap convention and is directly comparable.

When the user CAN supply the reference's actual pickled table
(``caption_options.cider_df`` -> :func:`load_df_pickle` -> ``set_df``),
absolute training-fitness parity is restored: the pickle is the
``{'document_frequency': {ngram tuple: count}, 'ref_len': log(N)}`` blob the
``cider`` submodule consumes for ``CiderD(df='coco-train-idxs')``
(reference: src/captioning/policies.py:72; the submodule loads it from
data/coco-train-idxs.p). N-gram keys there are tuples of token-id STRINGS
(the reference scores ``array_to_str`` id strings); we map them into this
module's int-tuple space.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ["CiderScorer", "cut_at_eos", "ngram_counts", "load_df_pickle"]


def load_df_pickle(path: str, n_max: int = 4):
    """Load a reference-format frozen DF pickle -> (df, ref_len) for
    :meth:`CiderScorer.set_df`.

    Format (what ``CiderD(df='coco-train-idxs')`` consumes,
    reference: src/captioning/policies.py:72): a pickled dict
    ``{'document_frequency': {ngram tuple: count}, 'ref_len': log(N)}``.
    The table is produced by self-critical.pytorch's prepro_ngrams over
    cocotalk token ids, so ngram keys are tuples of id STRINGS ('271', ...);
    int keys are accepted too. Orders above ``n_max`` are dropped. Loaded
    with ``encoding='latin1'`` — the published table is a Python-2 pickle."""
    import pickle

    with open(path, "rb") as f:
        blob = pickle.load(f, encoding="latin1")
    try:
        raw = blob["document_frequency"]
        ref_len = float(blob["ref_len"])
    except (TypeError, KeyError) as e:
        raise ValueError(
            f"cider_df {path}: expected a pickled dict with "
            f"'document_frequency' and 'ref_len' keys (the cider "
            f"submodule's coco-train-idxs format), got {type(blob).__name__}"
        ) from e
    df: list[dict] = [{} for _ in range(n_max)]
    for g, count in raw.items():
        try:
            key = tuple(int(t) for t in g)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"cider_df {path}: n-gram key {g!r} is not a tuple of "
                f"token ids — this loader expects an id-space table "
                f"(prepro_ngrams output), not a word-string table"
            ) from e
        if 1 <= len(key) <= n_max:
            df[len(key) - 1][key] = float(count)
    return df, ref_len


def cut_at_eos(seq) -> tuple:
    """Token tuple up to and INCLUDING the first 0 (array_to_str semantics)."""
    out = []
    for t in np.asarray(seq).tolist():
        out.append(int(t))
        if t == 0:
            break
    return tuple(out)


def ngram_counts(tokens: tuple, n_max: int = 4) -> list[dict]:
    """Per-order {ngram tuple: count} for orders 1..n_max."""
    out = [defaultdict(int) for _ in range(n_max)]
    L = len(tokens)
    for n in range(1, n_max + 1):
        d = out[n - 1]
        for i in range(L - n + 1):
            d[tokens[i : i + n]] += 1
    return [dict(d) for d in out]


class CiderScorer:
    """Reusable scorer: fit a DF table once, score batches of candidates.

    variant: 'cider-d' (clipped counts + length penalty — the training
    fitness) or 'cider' (plain — pycocoevalcap's validation metric).
    """

    def __init__(self, n: int = 4, sigma: float = 6.0, variant: str = "cider-d"):
        assert variant in ("cider-d", "cider")
        self.n = n
        self.sigma = sigma
        self.variant = variant
        self.df: list[dict] = [{} for _ in range(n)]
        self.ref_len = 0.0

    # ---- DF fitting -----------------------------------------------------------

    def fit_df(self, gts_tokens: list) -> "CiderScorer":
        """gts_tokens: per image, an array-like (M_i, T) of reference token
        rows. df[ngram] = number of images whose reference set contains it."""
        df = [defaultdict(int) for _ in range(self.n)]
        for refs in gts_tokens:
            seen = [set() for _ in range(self.n)]
            for row in np.asarray(refs):
                toks = cut_at_eos(row)
                for n in range(1, self.n + 1):
                    for i in range(len(toks) - n + 1):
                        seen[n - 1].add(toks[i : i + n])
            for n_i in range(self.n):
                for g in seen[n_i]:
                    df[n_i][g] += 1
        self.df = [dict(d) for d in df]
        self.ref_len = float(np.log(max(len(gts_tokens), 1)))
        return self

    def set_df(self, df: list[dict], ref_len: float) -> "CiderScorer":
        """Install a FROZEN document-frequency table (e.g. the reference's
        coco-train-idxs via :func:`load_df_pickle`) instead of fitting one:
        absolute scores then match the reference's training fitness exactly
        (rebuilt tables differ by a constant idf scale — module docstring)."""
        assert len(df) <= self.n
        self.df = [dict(d) for d in df] + [{} for _ in range(self.n - len(df))]
        self.ref_len = float(ref_len)
        return self

    # ---- vector construction -----------------------------------------------------

    def _vec(self, tokens: tuple):
        """(per-order {ngram: tf*idf}, per-order norm, length)."""
        counts = ngram_counts(tokens, self.n)
        vec, norm = [], []
        for n_i in range(self.n):
            d = {}
            s = 0.0
            for g, tf in counts[n_i].items():
                idf = self.ref_len - np.log(max(self.df[n_i].get(g, 0.0), 1.0))
                w = tf * idf
                d[g] = w
                s += w * w
            vec.append(d)
            norm.append(np.sqrt(s))
        return vec, norm, len(tokens)

    def _sim(self, vec_c, norm_c, len_c, vec_r, norm_r, len_r) -> np.ndarray:
        val = np.zeros(self.n)
        clip = self.variant == "cider-d"
        for n_i in range(self.n):
            d_r = vec_r[n_i]
            acc = 0.0
            for g, wc in vec_c[n_i].items():
                wr = d_r.get(g, 0.0)
                acc += (min(wc, wr) if clip else wc) * wr
            if norm_c[n_i] != 0 and norm_r[n_i] != 0:
                acc /= norm_c[n_i] * norm_r[n_i]
            val[n_i] = acc
        if clip:
            delta = float(len_c - len_r)
            val *= np.exp(-(delta**2) / (2 * self.sigma**2))
        return val

    # ---- scoring --------------------------------------------------------------------

    def score(self, cands, gts_per_cand, corpus_df: bool = False):
        """cands: (R, T) int array; gts_per_cand: length-R list of (M_i, T)
        reference arrays. Returns (mean_score, per_cand_scores[R]).

        corpus_df=True recomputes DF from the given references (plain-CIDEr
        validation mode); otherwise the fitted train DF is used.
        """
        cands = np.asarray(cands)
        if corpus_df:
            # DF over the distinct reference sets being scored
            seen_ids = {}
            uniq = []
            for refs in gts_per_cand:
                key = id(refs)
                if key not in seen_ids:
                    seen_ids[key] = True
                    uniq.append(refs)
            self.fit_df(uniq)

        ref_cache: dict = {}
        scores = np.zeros(len(cands))
        for i, (cand, refs) in enumerate(zip(cands, gts_per_cand)):
            vec_c, norm_c, len_c = self._vec(cut_at_eos(cand))
            key = id(refs)
            if key not in ref_cache:
                ref_cache[key] = [
                    self._vec(cut_at_eos(r)) for r in np.asarray(refs)
                ]
            ref_vecs = ref_cache[key]
            acc = np.zeros(self.n)
            for vec_r, norm_r, len_r in ref_vecs:
                acc += self._sim(vec_c, norm_c, len_c, vec_r, norm_r, len_r)
            scores[i] = 10.0 * float(np.mean(acc / len(ref_vecs)))
        return float(scores.mean()) if len(scores) else 0.0, scores
