"""CIDEr-D and CIDEr (Vedantam et al., CVPR 2015; the coco-caption
``CiderScorer``) in plain torch, for token rows.

A caption is its tokens up to and including the first 0 (all T without
one); its n-grams, n = 1..4, are counted per caption. The document
frequency of an n-gram is the number of images whose references hold it,
over the images the scorer is fitted on, and ``ref_len`` is log(images).
An n-gram's weight is tf * (ref_len - log(max(1, df))). Per order n the
similarity of a candidate and one reference is the product of their weight
vectors over the product of their norms (0 where a norm is 0); CIDEr-D
clips the candidate's weights at the reference's (``min``) and multiplies
by exp(-(len_c - len_r)^2 / (2 sigma^2)), sigma 6. A caption's score is 10
x the mean over n of the mean over its image's references.

An n-gram is the integer key sum_k (token_k + 1) << (14 k) over its n
slots: exact while the vocabulary stays below 16383 words. Every sum over
unique n-grams is taken over a caption's windows instead, each divided by
the window's count in the caption. This module shares no code with the
program's scorer.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Cider"]

N_MAX = 4
SIGMA = 6.0
BITS = 14


def _windows(T: int, device):
    """(start, order) of every window of a T-token row, order-major."""
    st, od = [], []
    for n in range(1, N_MAX + 1):
        for i in range(T - n + 1):
            st.append(i)
            od.append(n)
    return (torch.tensor(st, device=device), torch.tensor(od, device=device))


def ngrams(rows: torch.Tensor):
    """rows (N, T) int -> keys (N, W) int64, valid (N, W), order (W,),
    lens (N,) (EOS-inclusive)."""
    N, T = rows.shape
    st, od = _windows(T, rows.device)
    is0 = rows == 0
    lens = torch.where(is0.any(1), is0.int().argmax(1) + 1,
                       torch.full_like(is0[:, 0], T, dtype=torch.int64))
    keys = torch.zeros((N, st.numel()), dtype=torch.int64, device=rows.device)
    tok = rows.to(torch.int64) + 1
    for k in range(N_MAX):
        pos = (st + k).clamp(max=T - 1)
        keys += torch.where(k < od, tok[:, pos], 0) << (BITS * k)
    valid = (st + od)[None, :] <= lens[:, None]
    return keys, valid, od, lens


def _self_tf(keys, valid):
    """Each window's count among its row's valid windows (0 if invalid)."""
    eq = (keys[:, :, None] == keys[:, None, :]) & valid[:, None, :]
    return eq.sum(-1) * valid


class Cider:
    """Fitted on ``refs`` (I, M, T) int, the M references of each of I
    images (rows of zeros stand for no reference only where ``ref_mask``
    says so; here every image has M)."""

    def __init__(self, refs: torch.Tensor, variant: str = "cider-d",
                 chunk: int = 32768):
        if variant not in ("cider-d", "cider"):
            raise ValueError(variant)
        self.variant = variant
        self.chunk = chunk
        I, M, T = refs.shape
        self.M, self.T = M, T
        self.ref_len = math.log(I)
        keys, valid, od, lens = ngrams(refs.reshape(I * M, T))
        self.order = od
        # document frequency: distinct (n-gram, image) pairs per n-gram
        img = torch.arange(I, device=refs.device).repeat_interleave(M)
        img = img[:, None].expand_as(keys)
        k, im = keys[valid], img[valid]
        pairs = torch.unique(torch.stack([k, im], 1), dim=0)
        self.df_keys, self.df = torch.unique(pairs[:, 0], return_counts=True)
        ridf = self.idf(keys)
        norm2 = torch.zeros((I * M, N_MAX), dtype=torch.float64,
                            device=refs.device)
        for lo in range(0, I * M, chunk):
            sl = slice(lo, lo + chunk)
            tf = _self_tf(keys[sl], valid[sl]).to(torch.float64)
            w = tf * ridf[sl] ** 2
            for n in range(1, N_MAX + 1):
                norm2[sl, n - 1] = w[:, od == n].sum(1)
        self.ref_keys = torch.where(valid, keys, -1).reshape(I, M, -1)
        self.ref_norm = norm2.sqrt().reshape(I, M, N_MAX)
        self.ref_lens = lens.reshape(I, M)

    def idf(self, keys: torch.Tensor) -> torch.Tensor:
        """ref_len - log(max(1, df)) of each key, f64."""
        pos = torch.searchsorted(self.df_keys, keys).clamp(
            max=self.df_keys.numel() - 1)
        df = torch.where(self.df_keys[pos] == keys, self.df[pos], 0)
        return self.ref_len - torch.log(df.clamp(min=1).to(torch.float64))

    def score(self, rows: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """rows (N, T) int candidates of images img (N,) -> (N,) f64."""
        out = []
        step = self.chunk // 2
        for lo in range(0, rows.shape[0], step):
            out.append(self._score(rows[lo:lo + step], img[lo:lo + step]))
        return torch.cat(out)

    def _score(self, rows, img):
        keys, valid, od, lens = ngrams(rows)
        tf_c = _self_tf(keys, valid).to(torch.float64)
        idf2 = self.idf(keys) ** 2 * valid
        rk = self.ref_keys[img]                               # (N, M, Wr)
        ck = torch.where(valid, keys, -2)
        rod = self.order
        num = torch.zeros((rows.shape[0], N_MAX, self.M), dtype=torch.float64,
                          device=rows.device)
        normc = torch.zeros((rows.shape[0], N_MAX), dtype=torch.float64,
                            device=rows.device)
        for n in range(1, N_MAX + 1):
            c, r = od == n, rod == n
            tf_r = (ck[:, c, None, None] == rk[:, None, :, r]).sum(-1).to(
                torch.float64)                                # (N, Wc, M)
            tc = tf_c[:, c, None].clamp(min=1)
            cross = (torch.minimum(tc, tf_r) * tf_r if self.variant ==
                     "cider-d" else tc * tf_r)
            num[:, n - 1] = (cross * (idf2[:, c, None] / tc)).sum(1)
            normc[:, n - 1] = (tf_c[:, c] * idf2[:, c]).sum(1).sqrt()
        den = normc[:, :, None] * self.ref_norm[img].transpose(1, 2)
        sim = torch.where(den > 0, num / den.clamp(min=1e-300), 0.0)
        if self.variant == "cider-d":
            d = (lens[:, None] - self.ref_lens[img]).to(torch.float64)
            sim = sim * torch.exp(-(d * d) / (2.0 * SIGMA ** 2))[:, None, :]
        return 10.0 * (sim.sum(-1) / self.M).mean(-1)
