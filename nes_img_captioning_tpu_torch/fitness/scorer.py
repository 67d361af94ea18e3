"""Indexed CIDEr scoring facade (port of ``nes_img_captioning_tpu/fitness/scorer.py``).

``IndexedCiderScorer`` is what the task's host scorers consume (host
validation, ``CocoTask.train_scorer``): fit once on the per-image
ground-truth list, then score (candidates, image indices) batches. It runs
the native C++ core, ``csrc/ciderd.cpp`` (this package's copy of the JAX
package's ``native/ciderd.cpp``), compiled on first use with ``g++ -O3
-shared -fPIC`` into ``_build/`` inside this package and loaded with
``ctypes``. Unlike the JAX package's scorer, a failed build raises with the
compiler's output instead of falling back to Python: ``prefer_native=False``
is the one way to the pure-Python core (``ciderd.py``), the native core's
test oracle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .ciderd import CiderScorer

__all__ = ["IndexedCiderScorer", "SOURCE", "build_native", "load_native",
           "pack_ngram_u64"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ciderd.cpp"
_BUILD_DIR = _PKG / "_build"


def build_native(source: Path) -> Path:
    """Compile ``source`` into a shared library in ``_build/`` unless one
    built from the same bytes is there; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:12]
    lib = _BUILD_DIR / f"libciderd_{digest}.so"
    if lib.is_file():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: cannot build the native CIDEr "
                           f"scorer from {source}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the "
                           f"native CIDEr scorer from {source}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load(source: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native(source)))
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ptr = ctypes.POINTER
    lib.cider_new.restype = vp
    lib.cider_new.argtypes = [ci, ctypes.c_double, ci]
    lib.cider_free.restype = None
    lib.cider_free.argtypes = [vp]
    lib.cider_set_df.restype = None
    lib.cider_set_df.argtypes = [vp, ptr(ctypes.c_uint64),
                                 ptr(ctypes.c_float), ptr(ctypes.c_int32),
                                 i64, ctypes.c_double]
    lib.cider_fit.restype = None
    lib.cider_fit.argtypes = [vp, ptr(ctypes.c_int32), i64, ci, ptr(i64),
                              i64]
    lib.cider_score.restype = None
    lib.cider_score.argtypes = [vp, ptr(ctypes.c_int32), i64, ci, ptr(i64),
                                ptr(ctypes.c_double)]
    return lib


def load_native() -> ctypes.CDLL:
    """The native scorer built from ``SOURCE`` (once per process)."""
    return _load(Path(SOURCE))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_ngram_u64(g: tuple) -> int:
    """The native core's n-gram key: 16-bit fields of token+1, first token
    highest among the used fields (csrc/ciderd.cpp pack())."""
    h = 0
    for t in g:
        h = ((h << 16) | ((int(t) + 1) & 0xFFFF)) & 0xFFFFFFFFFFFFFFFF
    return h


class IndexedCiderScorer:
    """Fit on per-image reference lists, score candidates by image index.

    ``frozen_df``: optional ``(df, ref_len)`` from
    :func:`~nes_img_captioning_tpu_torch.fitness.ciderd.load_df_pickle` —
    score against a frozen DF table instead of fitting it from
    ``gts_list``. ``prefer_native=False`` runs the pure-Python core."""

    def __init__(self, gts_list: list, variant: str = "cider-d",
                 n: int = 4, sigma: float = 6.0, prefer_native: bool = True,
                 frozen_df: tuple | None = None):
        self.variant = variant
        self.n, self.sigma = n, sigma
        self._gts = [np.asarray(g, dtype=np.int32) for g in gts_list]
        self._native = self._py = None
        if prefer_native:
            self._fit_native(load_native(), frozen_df)
        else:
            self._py = CiderScorer(n=n, sigma=sigma, variant=variant)
            if frozen_df is not None:
                self._py.set_df(*frozen_df)
            else:
                self._py.fit_df(self._gts)

    def _fit_native(self, lib, frozen_df):
        self._lib = lib
        self._native = ctypes.c_void_p(lib.cider_new(
            self.n, self.sigma, 1 if self.variant == "cider-d" else 0))
        if frozen_df is not None:
            df, ref_len = frozen_df
            entries = [(pack_ngram_u64(g), float(count), n_i + 1)
                       for n_i, order_df in enumerate(df)
                       for g, count in order_df.items()]
            keys = np.asarray([e[0] for e in entries], np.uint64)
            vals = np.asarray([e[1] for e in entries], np.float32)
            orders = np.asarray([e[2] for e in entries], np.int32)
            lib.cider_set_df(self._native, _ptr(keys, ctypes.c_uint64),
                             _ptr(vals, ctypes.c_float),
                             _ptr(orders, ctypes.c_int32), len(keys),
                             float(ref_len))
        T = max((g.shape[1] for g in self._gts), default=1)
        refs = np.ascontiguousarray(np.concatenate(
            [np.pad(g, ((0, 0), (0, T - g.shape[1]))) for g in self._gts])
            if self._gts else np.zeros((0, T), np.int32), dtype=np.int32)
        img_ptr = np.concatenate([[0], np.cumsum(
            [g.shape[0] for g in self._gts])]).astype(np.int64)
        lib.cider_fit(self._native, _ptr(refs, ctypes.c_int32),
                      refs.shape[0], T, _ptr(img_ptr, ctypes.c_int64),
                      len(self._gts))

    def score(self, cands, img_idx):
        """cands (R, T) int tokens, img_idx (R,) fitted-image indices
        -> (mean, per-candidate scores)."""
        cands = np.ascontiguousarray(cands, dtype=np.int32)
        img_idx = np.ascontiguousarray(img_idx, dtype=np.int64)
        if cands.ndim != 2 or cands.shape[0] != img_idx.shape[0]:
            raise ValueError(f"candidates {cands.shape} for "
                             f"{img_idx.shape[0]} image indices")
        if self._native is None:
            return self._py.score(cands, [self._gts[i] for i in img_idx])
        if img_idx.size and not (0 <= img_idx.min()
                                 and img_idx.max() < len(self._gts)):
            raise ValueError(f"image index outside 0..{len(self._gts) - 1}")
        out = np.zeros(cands.shape[0], np.float64)
        self._lib.cider_score(self._native, _ptr(cands, ctypes.c_int32),
                              cands.shape[0], cands.shape[1],
                              _ptr(img_idx, ctypes.c_int64),
                              _ptr(out, ctypes.c_double))
        return (float(out.mean()) if len(out) else 0.0), out

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            self._lib.cider_free(self._native)
            self._native = None
