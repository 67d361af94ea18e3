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

from ..fitness.ciderd import CiderScorer
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

        if frozen_df is not None:
            fitted = CiderScorer(n=n, sigma=sigma, variant=variant).set_df(
                *frozen_df)
        else:
            fitted = CiderScorer(n=n, sigma=sigma, variant=variant).fit_df(gts)
        self.ref_len = float(fitted.ref_len)
        idf_by_key: dict[tuple[int, int], float] = {}
        stored = []
        for order_df in fitted.df:
            for g, df in order_df.items():
                idf = self.ref_len - np.log(max(df, 1.0))
                idf_by_key[_pack_tuple(g)] = idf
                # frozen tables carry float counts, so the test is > 1.0
                if df > 1.0:
                    stored.append((*_pack_tuple(g), idf))
        self._build_table(stored)
        self._build_refs(gts, idf_by_key)

    # ---- host-side builders ---------------------------------------------------

    BUCKET = 8  # slots per bucket; one row gather covers the whole bucket

    def _build_table(self, stored: list):
        """Bucketed idf table: key -> bucket by hash, all slots of a bucket
        in one row. The bucket count doubles until no bucket overflows."""
        n_keys = max(len(stored), 1)
        S = self.BUCKET
        n_buckets = 1 << max(int(np.ceil(np.log2(4 * n_keys / S))), 1)
        table = np.zeros((n_buckets, S, 3), np.int32)  # lo=0 => empty
        if stored:
            arr = np.asarray(stored, np.float64)
            lo = arr[:, 0].astype(np.int64)
            hi = arr[:, 1].astype(np.int64)
            idf = arr[:, 2].astype(np.float32)
            h = _hash_np(lo, hi).astype(np.int64)
            while True:
                bucket = h & (n_buckets - 1)
                if np.bincount(bucket, minlength=n_buckets).max() <= S:
                    break
                if n_buckets > (1 << 28):
                    raise RuntimeError(
                        f"idf bucket table cannot settle: >{S} keys share "
                        "one 32-bit hash; raise DeviceCider.BUCKET")
                n_buckets *= 2
            table = np.zeros((n_buckets, S, 3), np.int32)
            fill = np.zeros(n_buckets, np.int64)
            for j in np.argsort(bucket, kind="stable"):
                b = bucket[j]
                table[b, fill[b], 0] = lo[j]
                table[b, fill[b], 1] = hi[j]
                table[b, fill[b], 2] = idf[j: j + 1].view(np.int32)[0]
                fill[b] += 1
        self._bucket_mask = n_buckets - 1
        self.dev["table"] = torch.as_tensor(
            table.reshape(n_buckets, 3 * S), device=self.device)
        logger.info("device CIDEr idf table: %d keys, %d buckets x %d slots",
                    len(stored), n_buckets, S)

    def _build_refs(self, gts: list, idf_by_key: dict):
        n_img = len(gts)
        M = max((g.shape[0] for g in gts), default=1)
        T = max((g.shape[1] for g in gts), default=1)
        self._ref_T = T
        starts, orders = _window_meta(T, self.n)
        W = starts.shape[0]

        rows = np.zeros((n_img, M, T), np.int64)
        ref_mask = np.zeros((n_img, M), bool)
        for i, g in enumerate(gts):
            rows[i, : g.shape[0], : g.shape[1]] = g
            ref_mask[i, : g.shape[0]] = True

        flat = rows.reshape(-1, T)
        lens = _lens_np(flat)
        lo, hi, valid = _pack_np(flat, lens, starts, orders)
        # ref sentinel -3 never collides with candidate invalid (-1)
        lo = np.where(valid, lo, -3)
        hi = np.where(valid, hi, -3)

        # per-ref per-order norms ||g_n(r)||^2 = sum_j tf_j * idf_j^2
        key = (lo.astype(np.int64) << 32) | (hi.astype(np.int64) & _M32)
        uniq, inv = np.unique(key, return_inverse=True)
        if idf_by_key:
            dk = np.fromiter(
                ((np.int64(l) << 32) | (np.int64(h) & _M32)
                 for (l, h) in idf_by_key.keys()),
                np.int64, count=len(idf_by_key))
            dv = np.fromiter(idf_by_key.values(), np.float64,
                             count=len(idf_by_key)).astype(np.float32)
            srt = np.argsort(dk)
            dk, dv = dk[srt], dv[srt]
            pos = np.clip(np.searchsorted(dk, uniq), 0, len(dk) - 1)
            uvals = np.where(dk[pos] == uniq, dv[pos],
                             np.float32(self.ref_len))
        else:
            uvals = np.full(len(uniq), self.ref_len, np.float32)
        idf = uvals.astype(np.float32)[inv.reshape(-1)].reshape(
            flat.shape[0], W)

        norm2 = np.zeros((flat.shape[0], self.n), np.float32)
        CH = 8192
        off = 0
        for ni in range(1, self.n + 1):
            w = T - ni + 1
            sl = slice(off, off + w)
            off += w
            for s in range(0, flat.shape[0], CH):
                e = min(s + CH, flat.shape[0])
                lo_n, hi_n = lo[s:e, sl], hi[s:e, sl]
                valid_n = valid[s:e, sl]
                tf = (
                    (lo_n[:, :, None] == lo_n[:, None, :])
                    & (hi_n[:, :, None] == hi_n[:, None, :])
                    & valid_n[:, None, :]
                ).sum(axis=2)
                norm2[s:e, ni - 1] = (
                    tf * idf[s:e, sl] ** 2 * valid_n
                ).sum(axis=1)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        self.dev["ref_lo"] = put(lo.reshape(n_img, M, W))
        self.dev["ref_hi"] = put(hi.reshape(n_img, M, W))
        self.dev["ref_norm"] = put(
            np.sqrt(norm2).reshape(n_img, M, self.n).astype(np.float32))
        self.dev["ref_lens"] = put(lens.reshape(n_img, M).astype(np.int32))
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
