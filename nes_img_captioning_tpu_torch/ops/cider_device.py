"""On-device CIDEr-D (port of ``nes_img_captioning_tpu/ops/cider_device.py``).

The training-fitness scorer as plain torch on the card. The tables are built
on the host with numpy exactly as in the JAX package; ``score_rows`` is the
same arithmetic in torch. Design, unchanged:

* an n-gram (order 1..4) is a window of 4 token slots packed into two int32
  lanes of 14-bit fields (token+1; 0 = absent slot, which encodes the
  order) — window equality is two integer compares, no collisions;
* a caption of length T yields 4T-6 windows with static (start, order);
  windows past the EOS-inclusive length are masked;
* idf lookup is a bucketed hash table: one (BUCKET*3)-int32 row gather per
  window, the key compare inside the row; only n-grams with df >= 2 are
  stored (df in {0, 1} both give idf = ref_len, the miss default);
* per-image reference data (packed windows, per-order norms, EOS-inclusive
  lengths, ref mask) is precomputed once and gathered by image index;
* min(g_c, g_r) * g_r = min(tf_c, tf_r) * tf_r * idf^2, and summing over
  windows instead of unique n-grams is corrected by dividing by tf_c.

The bucket hash is uint32 arithmetic that wraps, with logical shifts. torch
has no uint32 multiply on every backend and its int32 ``>>`` is arithmetic,
so the hash runs in int64 on values masked to 32 bits, with each 32x32-bit
product split into 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..fitness.ciderd import CiderScorer, cut_at_eos
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["DeviceCider"]

_SHIFT = 14
_MAX_TOKEN = (1 << _SHIFT) - 2  # token+1 must fit the 14-bit field

# hash-mix constants (uint32 arithmetic, wraps)
_C1, _C2, _C3 = 0x9E3779B1, 0x85EBCA77, 0x2C1B3C6D
_M32 = 0xFFFFFFFF


def _window_meta(T: int, n_max: int = 4):
    """Static (starts, orders) for all n-gram windows of a length-T row."""
    starts, orders = [], []
    for n in range(1, n_max + 1):
        for i in range(T - n + 1):
            starts.append(i)
            orders.append(n)
    return np.asarray(starts, np.int32), np.asarray(orders, np.int32)


def _pack_np(rows: np.ndarray, lens: np.ndarray, starts, orders):
    """Host packing: rows (N, T) int, lens (N,) -> lo, hi (N, W) int32 and
    valid (N, W) bool. Invalid windows get lo = hi = -1."""
    N, T = rows.shape
    W = starts.shape[0]
    slots = np.zeros((N, W, 4), np.int64)
    for k in range(4):
        pos = np.minimum(starts + k, T - 1)
        tok = rows[:, pos] + 1
        slots[:, :, k] = np.where(k < orders[None, :], tok, 0)
    lo = (slots[:, :, 0] + (slots[:, :, 1] << _SHIFT)).astype(np.int32)
    hi = (slots[:, :, 2] + (slots[:, :, 3] << _SHIFT)).astype(np.int32)
    valid = (starts[None, :] + orders[None, :]) <= lens[:, None]
    lo = np.where(valid, lo, -1)
    hi = np.where(valid, hi, -1)
    return lo, hi, valid


def _lens_np(rows: np.ndarray) -> np.ndarray:
    """EOS-inclusive lengths (up to and INCLUDING the first 0)."""
    T = rows.shape[1]
    has0 = (rows == 0).any(axis=1)
    first0 = (rows == 0).argmax(axis=1)
    return np.where(has0, first0 + 1, T).astype(np.int32)


def _hash_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    lo = lo.astype(np.uint32)
    hi = hi.astype(np.uint32)
    h = lo * np.uint32(_C1) ^ hi * np.uint32(_C2)
    h ^= h >> np.uint32(15)
    h *= np.uint32(_C3)
    h ^= h >> np.uint32(12)
    return h


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32): the product of the
    low and high 16-bit halves stays below 2**49."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_torch(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``_hash_np`` on int32 tensors, as int64 values in [0, 2**32)."""
    h = _mul32(lo.to(torch.int64) & _M32, _C1) ^ \
        _mul32(hi.to(torch.int64) & _M32, _C2)
    h = h ^ (h >> 15)
    h = _mul32(h, _C3)
    return h ^ (h >> 12)


def _pack_tuple(g: tuple) -> tuple[int, int]:
    s = [t + 1 for t in g] + [0] * (4 - len(g))
    return s[0] + (s[1] << _SHIFT), s[2] + (s[3] << _SHIFT)


def _ref_windows(gts: list, n: int) -> dict:
    """The reference rows of every image packed into windows: rows padded
    to the most refs (M) and the widest row (T), ``ref_mask`` marking the
    real ones; ``lo``, ``hi``, ``valid`` and the EOS-inclusive ``lens`` per
    (image x M) row, and ``df_lens``, the lengths of the rows as
    ``cut_at_eos`` cuts them before the padding."""
    n_img = len(gts)
    M = max((g.shape[0] for g in gts), default=1)
    T = max((g.shape[1] for g in gts), default=1)
    starts, orders = _window_meta(T, n)
    rows = np.zeros((n_img, M, T), np.int64)
    ref_mask = np.zeros((n_img, M), bool)
    width = np.full((n_img, M), T, np.int64)
    for i, g in enumerate(gts):
        rows[i, : g.shape[0], : g.shape[1]] = g
        ref_mask[i, : g.shape[0]] = True
        width[i] = g.shape[1]
    flat = rows.reshape(-1, T)
    lens = _lens_np(flat)
    lo, hi, valid = _pack_np(flat, lens, starts, orders)
    return {"n_img": n_img, "M": M, "T": T, "starts": starts,
            "orders": orders, "ref_mask": ref_mask, "lens": lens,
            "df_lens": np.minimum(lens, width.reshape(-1)), "lo": lo,
            "hi": hi, "valid": valid}


def _set_ranks(refs: np.ndarray, n: int) -> dict:
    """{n-gram: its place in the iteration order of the image's set of
    order-n n-grams}, the set built by the insertions ``CiderScorer.
    fit_df`` makes, so its order is fit_df's."""
    seen = set()
    for row in np.asarray(refs):
        toks = cut_at_eos(row)
        for i in range(len(toks) - n + 1):
            seen.add(toks[i: i + n])
    return {g: r for r, g in enumerate(seen)}


class DeviceCider:
    """Fit once on the per-image ground-truth token lists; ``score_rows``
    returns the host oracle's per-caption scores (CiderScorer) to f32
    accuracy. The tables live in the ``dev`` dict of tensors on ``device``.
    Reference counterpart: one CiderD(df='coco-train-idxs') table per worker
    (src/captioning/policies.py:72)."""

    def __init__(self, gts_list: list, variant: str = "cider-d",
                 n: int = 4, sigma: float = 6.0,
                 frozen_df: tuple | None = None, device=None):
        if variant not in ("cider-d", "cider"):
            raise ValueError(f"variant {variant!r}: expected cider-d or cider")
        if n != 4:
            raise ValueError("window packing is specialized to n_max=4")
        self.variant = variant
        self.sigma = sigma
        self.n = n
        self.device = resolve_device(device)
        #: device tensors, filled by the builders below
        self.dev: dict = {}

        gts = [np.asarray(g, np.int64) for g in gts_list]
        if not all(g.max(initial=0) <= _MAX_TOKEN for g in gts):
            raise ValueError("vocab too large for 14-bit window packing")

        refs = _ref_windows(gts, n)
        if frozen_df is not None:
            fitted = CiderScorer(n=n, sigma=sigma, variant=variant).set_df(
                *frozen_df)
            self.ref_len = float(fitted.ref_len)
            keys, idf, stored = self._frozen_tables(fitted.df)
        else:
            # CiderScorer.fit_df's ref_len and document frequencies
            self.ref_len = float(np.log(max(len(gts), 1)))
            keys, idf, stored = self._fitted_tables(refs, gts)
        self._build_table(*stored)
        self._build_refs(refs, keys, idf)

    # ---- host-side builders ---------------------------------------------------

    BUCKET = 8  # slots per bucket; one row gather covers the whole bucket

    def _frozen_tables(self, df_list: list) -> tuple:
        """(every n-gram's packed key, its idf, the stored n-grams (df > 1)
        as (lo, hi, idf)) of a frozen DF table, in its dicts' order: frozen
        tables carry float counts, so the test is > 1.0."""
        keys, idf, stored = [], [], []
        for order_df in df_list:
            for g, df in order_df.items():
                lo, hi = _pack_tuple(g)
                v = self.ref_len - np.log(max(df, 1.0))
                keys.append((lo << 32) | hi)
                idf.append(v)
                if df > 1.0:
                    stored.append((lo, hi, v))
        arr = np.asarray(stored, np.float64).reshape(-1, 3)
        return (np.asarray(keys, np.int64), np.asarray(idf, np.float64),
                (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
                 arr[:, 2]))

    def _fitted_tables(self, refs: dict, gts: list) -> tuple:
        """``_frozen_tables`` of the DF that ``CiderScorer.fit_df`` fits on
        ``gts``, as array operations over the reference windows: an n-gram's
        df is the number of images whose references hold it (each ref row
        cut after its first 0, ``cut_at_eos``). The stored n-grams come in
        fit_df's dict order wherever it decides a bucket's slot order: by
        order, then the first image holding the n-gram, then, for n-grams
        first seen in the same image, that image's n-gram set's iteration
        order, rebuilt as fit_df builds it."""
        M, N = refs["M"], max(len(gts), 1)
        starts, orders = refs["starts"], refs["orders"]
        ok = (starts + orders)[None, :] <= refs["df_lens"][:, None]
        r, w = np.nonzero(ok & refs["ref_mask"].reshape(-1)[:, None])
        key = ((refs["lo"][r, w].astype(np.int64) << 32)
               | (refs["hi"][r, w].astype(np.int64) & _M32))
        keys, kinv = np.unique(key, return_inverse=True)
        # distinct (n-gram, image) pairs, ordered by n-gram then image
        pairs = np.unique(kinv.reshape(-1).astype(np.int64) * N + r // M)
        kk = pairs // N
        df = np.bincount(kk, minlength=keys.shape[0])
        first = pairs[np.searchsorted(kk, np.arange(keys.shape[0]))] % N
        idf = self.ref_len - np.log(np.maximum(df, 1).astype(np.float64))

        s = df > 1
        lo, hi, idf_s, first = keys[s] >> 32, keys[s] & _M32, idf[s], first[s]
        slots = [(lo & 0x3FFF), lo >> _SHIFT, (hi & 0x3FFF), hi >> _SHIFT]
        order = sum((f > 0).astype(np.int64) for f in slots)
        rank, sets = np.zeros(lo.shape[0], np.int64), {}
        if lo.shape[0]:
            bucket = _hash_np(lo, hi).astype(np.int64) & (
                self._bucket_count(lo, hi) - 1)
            group = (bucket * 5 + order) * N + first
            _, ginv, gcount = np.unique(group, return_inverse=True,
                                        return_counts=True)
            for j in np.nonzero(gcount[ginv] > 1)[0]:
                n_j, img = int(order[j]), int(first[j])
                if (img, n_j) not in sets:
                    sets[img, n_j] = _set_ranks(gts[img], n_j)
                rank[j] = sets[img, n_j][tuple(int(f[j]) - 1
                                               for f in slots[:n_j])]
        srt = np.lexsort((rank, first, order))
        return keys, idf, (lo[srt], hi[srt], idf_s[srt])

    def _bucket_count(self, lo: np.ndarray, hi: np.ndarray) -> int:
        """Buckets for the stored keys: the count doubles until no bucket
        overflows."""
        S = self.BUCKET
        n_buckets = 1 << max(int(np.ceil(np.log2(
            4 * max(lo.shape[0], 1) / S))), 1)
        h = _hash_np(lo, hi).astype(np.int64)
        while np.bincount(h & (n_buckets - 1),
                          minlength=n_buckets).max() > S:
            if n_buckets > (1 << 28):
                raise RuntimeError(
                    f"idf bucket table cannot settle: >{S} keys share one "
                    "32-bit hash; raise DeviceCider.BUCKET")
            n_buckets *= 2
        return n_buckets

    def _build_table(self, lo: np.ndarray, hi: np.ndarray, idf: np.ndarray):
        """Bucketed idf table of the stored keys: key -> bucket by hash, all
        slots of a bucket in one row, filled in the keys' order."""
        S = self.BUCKET
        n_buckets = self._bucket_count(lo, hi)
        table = np.zeros((n_buckets, S, 3), np.int32)  # lo=0 => empty
        if lo.shape[0]:
            bucket = _hash_np(lo, hi).astype(np.int64) & (n_buckets - 1)
            j = np.argsort(bucket, kind="stable")
            b = bucket[j]
            slot = np.arange(b.shape[0]) - np.searchsorted(b, b)
            table[b, slot, 0] = lo[j]
            table[b, slot, 1] = hi[j]
            table[b, slot, 2] = idf[j].astype(np.float32).view(np.int32)
        self._bucket_mask = n_buckets - 1
        self.dev["table"] = torch.as_tensor(
            table.reshape(n_buckets, 3 * S), device=self.device)
        logger.info("device CIDEr idf table: %d keys, %d buckets x %d slots",
                    lo.shape[0], n_buckets, S)

    def _build_refs(self, refs: dict, keys: np.ndarray, idf: np.ndarray):
        """The per-image reference tables: packed windows, per-order norms,
        EOS-inclusive lengths and masks; ``keys`` / ``idf`` every n-gram of
        the DF table with its idf (a window outside it takes ref_len)."""
        M, T, n_img = refs["M"], refs["T"], refs["n_img"]
        self._ref_T = T
        W = refs["starts"].shape[0]
        lo, hi, valid = refs["lo"], refs["hi"], refs["valid"]
        # ref sentinel -3 never collides with candidate invalid (-1)
        lo = np.where(valid, lo, -3)
        hi = np.where(valid, hi, -3)

        # per-ref per-order norms ||g_n(r)||^2 = sum_j tf_j * idf_j^2
        key = (lo.astype(np.int64) << 32) | (hi.astype(np.int64) & _M32)
        uniq, inv = np.unique(key, return_inverse=True)
        if keys.shape[0]:
            srt = np.argsort(keys)
            dk, dv = keys[srt], idf[srt].astype(np.float32)
            pos = np.clip(np.searchsorted(dk, uniq), 0, len(dk) - 1)
            uvals = np.where(dk[pos] == uniq, dv[pos],
                             np.float32(self.ref_len))
        else:
            uvals = np.full(len(uniq), self.ref_len, np.float32)
        rows_n = lo.shape[0]
        idf_w = uvals.astype(np.float32)[inv.reshape(-1)].reshape(rows_n, W)

        norm2 = np.zeros((rows_n, self.n), np.float32)
        CH = 8192
        off = 0
        for ni in range(1, self.n + 1):
            w = T - ni + 1
            sl = slice(off, off + w)
            off += w
            for s in range(0, rows_n, CH):
                e = min(s + CH, rows_n)
                lo_n, hi_n = lo[s:e, sl], hi[s:e, sl]
                valid_n = valid[s:e, sl]
                tf = (
                    (lo_n[:, :, None] == lo_n[:, None, :])
                    & (hi_n[:, :, None] == hi_n[:, None, :])
                    & valid_n[:, None, :]
                ).sum(axis=2)
                norm2[s:e, ni - 1] = (
                    tf * idf_w[s:e, sl] ** 2 * valid_n
                ).sum(axis=1)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        ref_mask = refs["ref_mask"]
        self.dev["ref_lo"] = put(lo.reshape(n_img, M, W))
        self.dev["ref_hi"] = put(hi.reshape(n_img, M, W))
        self.dev["ref_norm"] = put(
            np.sqrt(norm2).reshape(n_img, M, self.n).astype(np.float32))
        self.dev["ref_lens"] = put(
            refs["lens"].reshape(n_img, M).astype(np.int32))
        self.dev["ref_mask"] = put(ref_mask)
        self.dev["ref_count"] = put(ref_mask.sum(axis=1).astype(np.float32))

    # ---- device side -------------------------------------------------------------

    def _idf_lookup(self, lo, hi, table):
        """One bucket-row gather per window; misses resolve to ref_len."""
        bucket = _hash_torch(lo, hi) & self._bucket_mask
        rows = table[bucket].reshape(*bucket.shape, self.BUCKET, 3)
        hit = (rows[..., 0] == lo[..., None]) & (rows[..., 1] == hi[..., None])
        vals = rows[..., 2].contiguous().view(torch.float32)
        return torch.where(hit.any(-1),
                           torch.where(hit, vals, 0.0).sum(-1),
                           self.ref_len)

    def _pack_rows(self, seqs):
        """(R, T) int tokens -> lo, hi (R, W) int32, valid (R, W), lens (R,),
        windows laid out order-major like _window_meta; invalid windows
        carry -1."""
        T = seqs.shape[-1]
        shifted = seqs.to(torch.int32) + 1
        is0 = seqs == 0
        lens = torch.where(is0.any(-1), is0.to(torch.int32).argmax(-1) + 1, T)
        lo_parts, hi_parts, valid_parts = [], [], []
        ar = torch.arange(T, device=seqs.device)
        for n in range(1, self.n + 1):
            w = T - n + 1
            slot = [shifted[..., k: w + k] if k < n
                    else torch.zeros_like(shifted[..., :w]) for k in range(4)]
            lo_parts.append(slot[0] + (slot[1] << _SHIFT))
            hi_parts.append(slot[2] + (slot[3] << _SHIFT))
            valid_parts.append((ar[:w] + n)[None, :] <= lens[:, None])
        lo = torch.cat(lo_parts, dim=-1)
        hi = torch.cat(hi_parts, dim=-1)
        valid = torch.cat(valid_parts, dim=-1)
        lo = torch.where(valid, lo, -1)
        hi = torch.where(valid, hi, -1)
        return lo, hi, valid, lens

    def score_rows(self, seqs, img_ids, dev: dict | None = None):
        """seqs (R, T) int tokens, img_ids (R,) indices into the fitted image
        list -> (R,) f32 CIDEr[-D] scores (x10 scale, as the host scorer)."""
        if dev is None:
            dev = self.dev
        img_ids = img_ids.to(torch.long)
        lo, hi, valid, lens = self._pack_rows(seqs)
        idf = torch.where(valid, self._idf_lookup(lo, hi, dev["table"]), 0.0)
        idf2 = idf * idf

        rlo = dev["ref_lo"][img_ids]
        rhi = dev["ref_hi"][img_ids]

        # windows of different orders never match, so the tf compares run
        # per order
        T = seqs.shape[-1]
        Tr = self._ref_T
        num_parts, normc_parts = [], []
        off_c = off_r = 0
        for n in range(1, self.n + 1):
            wc, wr = T - n + 1, Tr - n + 1
            lo_n = lo[:, off_c: off_c + wc]
            hi_n = hi[:, off_c: off_c + wc]
            valid_n = valid[:, off_c: off_c + wc]
            idf2_n = idf2[:, off_c: off_c + wc]
            rlo_n = rlo[:, :, off_r: off_r + wr]
            rhi_n = rhi[:, :, off_r: off_r + wr]
            off_c += wc
            off_r += wr

            eq_cc = ((lo_n[:, :, None] == lo_n[:, None, :])
                     & (hi_n[:, :, None] == hi_n[:, None, :])
                     & valid_n[:, None, :])
            tf_c = torch.clamp(eq_cc.sum(-1), min=1).to(torch.float32)

            tf_r = ((lo_n[:, :, None, None] == rlo_n[:, None, :, :])
                    & (hi_n[:, :, None, None] == rhi_n[:, None, :, :])
                    ).sum(-1).to(torch.float32)

            if self.variant == "cider-d":
                cross = torch.minimum(tf_c[:, :, None], tf_r) * tf_r
            else:
                cross = tf_c[:, :, None] * tf_r
            num_parts.append((cross * (idf2_n / tf_c)[:, :, None]).sum(1))
            normc_parts.append((tf_c * idf2_n * valid_n).sum(-1))

        num = torch.stack(num_parts, dim=1)  # (R, 4, M)
        norm_c = torch.sqrt(torch.stack(normc_parts, dim=1))  # (R, 4)
        norm_r = dev["ref_norm"][img_ids]  # (R, M, 4)
        denom = norm_c[:, :, None] * norm_r.transpose(1, 2)
        sim = torch.where(denom > 0, num / torch.clamp(denom, min=1e-30), 0.0)

        if self.variant == "cider-d":
            dlen = (lens[:, None] - dev["ref_lens"][img_ids]).to(torch.float32)
            pen = torch.exp(-(dlen * dlen) / (2.0 * self.sigma ** 2))
            sim = sim * pen[:, None, :]

        sim = sim * dev["ref_mask"][img_ids][:, None, :]
        per_order = sim.sum(-1) / dev["ref_count"][img_ids][:, None]
        return 10.0 * per_order.mean(-1)
