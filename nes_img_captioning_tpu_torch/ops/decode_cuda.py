"""Fused greedy decode of the FC captioner: CUDA C++ kernels for Hopper.

Port of ``nes_img_captioning_tpu/ops/decode_pallas.py`` for this slice:

* ``decode_fused`` (K1) replaces the Pallas ``decode_fused`` with
  ``greedy=True, vocab_tile=0`` (``decode_pallas.py:614-689``, body
  ``_decode_core`` ``:52-239``): one member's greedy caption for a batch of
  images;
* ``decode_pair_perturb`` (K2) replaces the Pallas ``decode_pair_perturb``
  (``decode_pallas.py:295-354``, body ``_pair_kernel`` ``:251-288``): both
  signs of one antithetic pair, the weights formed as
  ``dt(f32(base) + sign * f32(delta))`` inside the kernel;
* ``decode_pair_rng`` (K5) replaces the Pallas ``decode_pair_rng``
  (``decode_pallas.py:466-518``): K2 with the f32 delta
  ``scale * N(0, 1)`` made in the kernel from the pair's uint32 seed;
* ``pair_grad_rng`` (K6) replaces the Pallas ``pair_grad_rng``
  (``decode_pallas.py:575-607``): ``sum_i w_i * delta(seed_i)``, each delta
  drawn again from its seed;
* ``pair_delta_dump`` (K7) replaces the Pallas ``pair_delta_dump``
  (``decode_pallas.py:526-551``): the delta K5 and K6 realize for a seed.

K5-K7 share one noise stream, a Philox4x32-10 counter keyed on (seed,
element index) (``ops/noise.py`` has its definition and plain version), so
their deltas are bitwise equal; the stream is not the TPU's (a deliberate
deviation, README). K6 and K7 are elementwise and bound by drawing the
normals; the notes in ``csrc/decode.cu`` give each kernel's design.

Kernel sources: ``csrc/decode.cu``, built with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (loaded with ``ctypes``) on first
use, into ``_build/`` inside this package.

What bounds them on an H100, and the design. One CTA decodes one member
(K1) or one sign of one pair (K2) for all B <= 128 rows, so the batch-wide
early exit stays inside the CTA. The 17-step recurrence is serial; the work
per step is three products (i2h, h2h: 128x128x640 each; logits:
128x128xVpad) whose weights (~5.8 MB per member in bf16, far above an SM's
227 KB of shared memory) stream from L2 as 128-row tiles into shared
memory. K2 forms ``dt(base + sign*delta)`` as it loads a tile, so no
perturbed weight vector is written out. The bound is arithmetic: the logits
alone are 2*128*128*Vpad FLOP per step and member (about 1.45 TFLOP per
generation at the bench settings) against 989 TFLOP/s of bf16 tensor-core
peak. With bf16 weights the logit product runs on the tensor cores
(``mma.sync`` m16n8k16, f32 accumulate); the gate products multiply the
unrounded f32 ``h`` and stay f32 FMAs on the CUDA cores, as does every
product of the f32 path. The logits never leave registers: each thread
keeps a running max / first-index argmax / online sum-of-exp over its
columns, merged across threads with ties to the smaller index. A launch
covers a whole chunk of members or pairs (the JAX package ``vmap``s over
the chunk), one CTA each, so a chunk of 24 pairs fills 48 of the 132 SMs;
``wgmma``, TMA and more CTAs per member are later work.

Each kernel has a plain PyTorch twin with the same signature, following the
JAX kernel's rounding points (weights and feats in ``dt``, products with f32
accumulation, ``h`` kept f32 for the h2h product and rounded to ``dt`` for
the logits, gates/c/h in f32). The wrappers run the twin only for CPU
tensors; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .noise import philox4x32_10, philox_normal_plain

__all__ = ["PAD_LANE", "NEG", "pad_vocab", "prepare_decode_params",
           "decode_fused", "decode_fused_plain", "decode_pair_perturb",
           "decode_pair_perturb_plain", "decode_pair_rng",
           "decode_pair_rng_plain", "pair_delta_dump", "pair_delta_dump_plain",
           "pair_grad_rng", "pair_grad_rng_plain", "philox_words", "build_kernels",
           "PAIR_TENSORS"]

PAD_LANE = 128
NEG = -1e9

# the kernels' fixed widths: E = R = 128, B <= 128 rows per CTA, feature
# width a multiple of 128
KERNEL_WIDTH = 128

PAIR_TENSORS = ("img_w", "img_b", "i2h_w", "i2h_b", "h2h_w", "h2h_b",
                "logit_w", "logit_b", "embed")
_BIASES = ("img_b", "i2h_b", "h2h_b", "logit_b")

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "decode.cu",)
_BUILD_DIR = _PKG / "_build"


def pad_vocab(v1: int) -> int:
    return ((v1 + PAD_LANE - 1) // PAD_LANE) * PAD_LANE


def prepare_decode_params(spec, theta: torch.Tensor, options,
                          dtype=torch.float32) -> dict:
    """Flat torch-order theta -> the padded-weight dict the kernels take.
    Weights are transposed to (in, out) and cast to ``dtype``; vocab axes
    are padded to the 128 multiple; biases stay f32 and (1, N)-shaped, the
    padded logit bias at ``NEG`` so a pad token never wins the argmax."""
    p = spec.unravel(theta)
    V1 = options.vocab_size + 1
    pad = pad_vocab(V1) - V1
    f32 = torch.float32
    F = torch.nn.functional
    return {
        "img_w": p["img_embed.weight"].t().to(dtype).contiguous(),
        "img_b": p["img_embed.bias"].to(f32)[None, :].contiguous(),
        "i2h_w": p["core.i2h.weight"].t().to(dtype).contiguous(),
        "i2h_b": p["core.i2h.bias"].to(f32)[None, :].contiguous(),
        "h2h_w": p["core.h2h.weight"].t().to(dtype).contiguous(),
        "h2h_b": p["core.h2h.bias"].to(f32)[None, :].contiguous(),
        "logit_w": F.pad(p["logit.weight"].t(), (0, pad)).to(dtype)
        .contiguous(),
        "logit_b": F.pad(p["logit.bias"], (0, pad), value=NEG).to(f32)
        [None, :].contiguous(),
        "embed": F.pad(p["embed.weight"], (0, 0, 0, pad)).to(dtype)
        .contiguous(),
    }


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _batched(params: dict, feats: torch.Tensor):
    """Lift an unbatched (one member) call to the batched layout: params
    gain a leading member axis and feats become (M, B, F)."""
    single = params["img_w"].dim() == 2
    if single:
        params = {k: v[None] for k, v in params.items()}
    if feats.dim() == 2:
        feats = feats[None].expand(params["img_w"].shape[0], *feats.shape)
    return params, feats, single


def decode_fused_plain(params: dict, feats: torch.Tensor,
                       seq_length: int = 16, need_logprobs: bool = True, *,
                       top2_gap: bool = False):
    """Plain twin of K1. params: one member's dict (prepare_decode_params)
    or a batch of them with a leading member axis M; feats (B, F) or
    (M, B, F). Returns (seq (…, B, T) int32, lp (…, B, T) f32), and with
    ``top2_gap`` also each step's gap between the two largest logits (…,
    B, T) — how near a tie each greedy choice was, for holding a kernel
    that sums in another order to these tokens."""
    params, feats, single = _batched(params, feats)
    f32 = torch.float32
    dt = params["img_w"].dtype
    R = params["h2h_w"].shape[-2]
    M, B = feats.shape[0], feats.shape[1]
    dev = feats.device

    def dott(x, w):  # products of dt values are exact in f32; f32 sums
        return torch.matmul(x.to(f32), w.to(f32))

    def lstm(xt, h, c):
        a = (dott(xt, params["i2h_w"]) + params["i2h_b"]
             + dott(h, params["h2h_w"]) + params["h2h_b"])
        gates = torch.sigmoid(a[..., :3 * R])
        i_g, f_g, o_g = gates[..., :R], gates[..., R:2 * R], gates[..., 2 * R:]
        cand = torch.maximum(a[..., 3 * R:4 * R], a[..., 4 * R:])
        c2 = f_g * c + i_g * cand
        return o_g * torch.tanh(c2), c2

    x0 = dott(feats.to(dt), params["img_w"]) + params["img_b"]
    zeros = torch.zeros((M, B, R), dtype=f32, device=dev)
    h, c = lstm(x0.to(dt), zeros, zeros)

    rows = torch.arange(M, device=dev)[:, None]
    tok = torch.zeros((M, B), dtype=torch.long, device=dev)
    unfin = torch.ones((M, B), dtype=torch.bool, device=dev)
    alive = torch.ones((M, 1), dtype=torch.bool, device=dev)
    seq, lps, gaps = [], [], []
    for _ in range(seq_length):
        h, c = lstm(params["embed"][rows, tok], h, c)
        logits = dott(h.to(dt), params["logit_w"]) + params["logit_b"]
        if top2_gap:
            top = logits.topk(2, dim=-1).values
            gaps.append(torch.where(alive, top[..., 0] - top[..., 1], 0.0))
        if need_logprobs:
            mx = logits.max(dim=-1, keepdim=True).values
            lse = mx + torch.log(torch.exp(logits - mx).sum(-1, keepdim=True))
            lp_tok = (mx - lse)[..., 0]
        else:
            lp_tok = torch.zeros((M, B), dtype=f32, device=dev)
        new = logits.argmax(dim=-1)  # first index on ties, like jnp.argmax
        unfin = unfin & (new > 0)
        tok = new * unfin
        # a member whose rows have all finished skips its remaining steps:
        # its outputs stay 0, as in the kernel
        seq.append(torch.where(alive, tok, 0).to(torch.int32))
        lps.append(torch.where(alive, lp_tok, 0.0))
        alive = alive & unfin.any(-1, keepdim=True)
    out = [torch.stack(seq, -1), torch.stack(lps, -1)]
    if top2_gap:
        out.append(torch.stack(gaps, -1))
    return tuple(o[0] for o in out) if single else tuple(out)


def _perturbed(base: dict, delta: dict, sign: float, dtype) -> dict:
    """dt(f32(base) + sign * f32(delta)); biases stay f32 — the arithmetic
    of DecodeLayout.prep(base_vec ± delta)."""
    return {k: (base[k] + sign * delta[k].to(torch.float32)).to(
        torch.float32 if k in _BIASES else dtype) for k in PAIR_TENSORS}


def decode_pair_perturb_plain(base: dict, delta: dict, feats: torch.Tensor,
                              seq_length: int = 16, dtype=torch.float32,
                              need_logprobs: bool = False):
    """Plain twin of K2. base: f32 dict (one member, unbatched). delta: the
    same shapes in f32 or bf16, for one pair or with a leading pair axis P.
    feats (B, F) or (P, B, F). Returns (seq, lp) of shape (2, B, T) for one
    pair or (P, 2, B, T); index 0 is +delta."""
    outs = [decode_fused_plain(_perturbed(base, delta, s, dtype), feats,
                               seq_length, need_logprobs) for s in (1.0, -1.0)]
    axis = 0 if delta["img_w"].dim() == 2 else 1
    return (torch.stack([o[0] for o in outs], axis),
            torch.stack([o[1] for o in outs], axis))


def _seeds_u32(seeds) -> tuple[np.ndarray, bool]:
    """Host seeds (an int, or a 1-D sequence / array / CPU tensor) -> (P,)
    uint32 and whether a single seed was given."""
    arr = np.asarray(seeds.cpu() if torch.is_tensor(seeds) else seeds)
    single = arr.ndim == 0
    return (arr.reshape(-1).astype(np.int64) & 0xFFFFFFFF).astype(
        np.uint32), single


def _flat_scale(scale: dict) -> torch.Tensor:
    """A decode-layout dict -> the flat f32 vector in decode order (the
    element index ``j`` of the noise stream)."""
    return torch.cat([scale[k].to(torch.float32).reshape(-1)
                      for k in PAIR_TENSORS])


def _as_dict(flat: torch.Tensor, like: dict) -> dict:
    """(..., dim) in decode order -> a dict of (..., *shape) contiguous
    tensors shaped like ``like``."""
    out, off = {}, 0
    for k in PAIR_TENSORS:
        n = like[k].numel()
        out[k] = flat[..., off:off + n].reshape(
            *flat.shape[:-1], *like[k].shape).contiguous()
        off += n
    return out


def pair_delta_dump_plain(scale: dict, seeds) -> dict:
    """Plain twin of K7: the f32 delta ``scale * N(0, 1)`` of each seed, as
    a dict shaped like ``scale`` (a leading seed axis P unless ``seeds`` is
    a single int)."""
    u32, single = _seeds_u32(seeds)
    flat = _flat_scale(scale)
    j = torch.arange(flat.shape[0], device=flat.device)
    deltas = torch.stack([philox_normal_plain(int(s), j, flat) for s in u32])
    return _as_dict(deltas[0] if single else deltas, scale)


def pair_grad_rng_plain(scale: dict, seeds, weights) -> dict:
    """Plain twin of K6: ``sum_i weights[i] * delta(seeds[i])`` in pair
    order, each product rounded to f32 before it is added — the kernel's
    order. Returns an f32 dict shaped like ``scale``."""
    u32, _ = _seeds_u32(seeds)
    flat = _flat_scale(scale)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=flat.device).reshape(-1)
    _check(w.shape[0] == u32.shape[0],
           f"{w.shape[0]} weights for {u32.shape[0]} seeds")
    j = torch.arange(flat.shape[0], device=flat.device)
    g = torch.zeros_like(flat)
    for i, s in enumerate(u32):
        g = g + w[i] * philox_normal_plain(int(s), j, flat)
    return _as_dict(g, scale)


def decode_pair_rng_plain(base: dict, scale: dict, seeds, feats: torch.Tensor,
                          seq_length: int = 16, dtype=torch.float32,
                          need_logprobs: bool = False):
    """Plain twin of K5: K2's plain twin fed K7's plain f32 delta of each
    seed. Returns (seq, lp) of shape (2, B, T) for a single seed or
    (P, 2, B, T); index 0 is +delta."""
    return decode_pair_perturb_plain(base, pair_delta_dump_plain(scale, seeds),
                                     feats, seq_length, dtype, need_logprobs)


# ---------------------------------------------------------------------------
# kernel build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the decode kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return found


def build_kernels() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` for sm_90a into ``_build/`` unless a library
    built from the same sources is already there. Returns (library path,
    the compiler's ptxas report; empty when nothing was compiled)."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _SOURCES))
    lib = _BUILD_DIR / f"libnes_decode_{digest.hexdigest()[:12]}.so"
    if lib.is_file():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_kernels()[0]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nes_decode_fused.argtypes = [ci] * 7 + [vp] * 10 + [vp] * 2 + [vp]
    lib.nes_decode_fused.restype = ci
    lib.nes_decode_pair_perturb.argtypes = \
        [ci] * 8 + [vp] * (1 + 9 + 9) + [vp] * 2 + [vp]
    lib.nes_decode_pair_perturb.restype = ci
    lib.nes_decode_pair_rng.argtypes = \
        [ci] * 7 + [vp] * (1 + 9) + [vp] * 3 + [vp] * 2 + [vp]
    lib.nes_decode_pair_rng.restype = ci
    i64 = ctypes.c_longlong
    lib.nes_pair_delta_dump.argtypes = [ci, i64] + [vp] * 3 + [vp]
    lib.nes_pair_delta_dump.restype = ci
    lib.nes_pair_grad_rng.argtypes = [ci, i64] + [vp] * 4 + [vp]
    lib.nes_pair_grad_rng.restype = ci
    lib.nes_philox_words.argtypes = [ctypes.c_uint, i64, vp, vp]
    lib.nes_philox_words.restype = ci
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_params(params: dict, M: int, F: int, dt, what="params"):
    """Shapes, dtypes, device and contiguity of a batched params dict:
    weights in ``dt``, biases f32 (DecodeLayout.prep keeps every bias f32,
    a delta's too)."""
    W = KERNEL_WIDTH
    Vpad = params["logit_w"].shape[-1]
    expect = {"img_w": (M, F, W), "img_b": (M, 1, W),
              "i2h_w": (M, W, 5 * W), "i2h_b": (M, 1, 5 * W),
              "h2h_w": (M, W, 5 * W), "h2h_b": (M, 1, 5 * W),
              "logit_w": (M, W, Vpad), "logit_b": (M, 1, Vpad),
              "embed": (M, Vpad, W)}
    _check(Vpad % PAD_LANE == 0, f"{what}: padded vocab {Vpad} is not a "
           f"multiple of {PAD_LANE}")
    _check(F % W == 0, f"{what}: feature width {F} is not a multiple of {W}")
    for k, shape in expect.items():
        t = params[k]
        _check(tuple(t.shape) == shape,
               f"{what}[{k}]: shape {tuple(t.shape)} != {shape} (the kernels "
               f"take E = R = {W})")
        want = torch.float32 if k in _BIASES else dt
        _check(t.dtype == want, f"{what}[{k}]: dtype {t.dtype} != {want}")
        _check(t.is_cuda, f"{what}[{k}] is not a CUDA tensor")
        _check(t.is_contiguous(), f"{what}[{k}] is not contiguous")
    return Vpad


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def decode_fused(params: dict, feats: torch.Tensor, seq_length: int = 16,
                 need_logprobs: bool = True):
    """K1: greedy decode of one member, or of a batch of members in one
    launch (params with a leading member axis M, feats (M, B, F)). CPU
    tensors run the plain twin; CUDA tensors launch the kernel."""
    if not feats.is_cuda:
        return decode_fused_plain(params, feats, seq_length, need_logprobs)
    dt = params["img_w"].dtype
    _check(dt in _DTYPE_CODE, f"weight dtype {dt} is not f32 or bf16")
    params, feats, single = _batched(params, feats)
    M, B, F = feats.shape
    _check(1 <= B <= KERNEL_WIDTH, f"batch {B} outside 1..{KERNEL_WIDTH}")
    Vpad = _check_params(params, M, F, dt)
    feats = feats.to(dt).contiguous()
    _check(feats.device == params["img_w"].device, "feats on another device")
    seq = torch.empty((M, B, seq_length), dtype=torch.int32,
                      device=feats.device)
    lp = torch.empty((M, B, seq_length), dtype=torch.float32,
                     device=feats.device)
    err = _kernels().nes_decode_fused(
        _DTYPE_CODE[dt], int(need_logprobs), M, B, F, Vpad, seq_length,
        feats.data_ptr(), *(params[k].data_ptr() for k in PAIR_TENSORS),
        seq.data_ptr(), lp.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _raise_on(err, "decode_fused")
    decode_fused.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_fused.launches = 0


def decode_pair_perturb(base: dict, delta: dict, feats: torch.Tensor,
                        seq_length: int = 16, dtype=torch.float32,
                        need_logprobs: bool = False):
    """K2: both signs of antithetic pairs with the perturbation applied in
    the kernel. base: f32 dict (unbatched, shared by the pairs); delta: f32
    or bf16, one pair or a leading pair axis P; feats (B, F) or (P, B, F).
    ``dtype`` is the compute dtype of the perturbed weights. Returns (seq,
    lp) of shape (2, B, T) or (P, 2, B, T); index 0 is +delta. Tokens equal
    ``decode_fused(prep(base ± delta))`` bit for bit: the same sum, rounded
    once to the same dtype, feeds the same kernel code."""
    if not feats.is_cuda:
        return decode_pair_perturb_plain(base, delta, feats, seq_length,
                                         dtype, need_logprobs)
    _check(dtype in _DTYPE_CODE, f"compute dtype {dtype} is not f32 or bf16")
    ddt = delta["img_w"].dtype
    _check(ddt in _DTYPE_CODE, f"delta dtype {ddt} is not f32 or bf16")
    single = delta["img_w"].dim() == 2
    if single:
        delta = {k: v[None] for k, v in delta.items()}
    P = delta["img_w"].shape[0]
    if feats.dim() == 2:
        feats = feats[None].expand(P, *feats.shape)
    _, B, F = feats.shape
    _check(feats.shape[0] == P, f"feats lead {feats.shape[0]} != pairs {P}")
    _check(1 <= B <= KERNEL_WIDTH, f"batch {B} outside 1..{KERNEL_WIDTH}")
    Vpad = _check_params({k: v[None] for k, v in base.items()}, 1, F,
                         torch.float32, what="base")
    _check(_check_params(delta, P, F, ddt, what="delta") == Vpad,
           "base and delta vocab differ")
    feats = feats.to(dtype).contiguous()
    _check(feats.device == base["img_w"].device, "feats on another device")
    seq = torch.empty((P, 2, B, seq_length), dtype=torch.int32,
                      device=feats.device)
    lp = torch.empty((P, 2, B, seq_length), dtype=torch.float32,
                     device=feats.device)
    err = _kernels().nes_decode_pair_perturb(
        _DTYPE_CODE[dtype], _DTYPE_CODE[ddt], int(need_logprobs), P, B, F,
        Vpad, seq_length, feats.data_ptr(),
        *(base[k].data_ptr() for k in PAIR_TENSORS),
        *(delta[k].data_ptr() for k in PAIR_TENSORS),
        seq.data_ptr(), lp.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _raise_on(err, "decode_pair_perturb")
    decode_pair_perturb.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_pair_perturb.launches = 0


def _seeds_on(u32: np.ndarray, device) -> torch.Tensor:
    """uint32 seeds as an int32 tensor of the same bits on ``device`` (the
    kernels read them as uint32)."""
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32)).to(
        device)


def _check_scale(scale: dict, like: dict) -> torch.Tensor:
    """A noise-scale dict of ``like``'s shapes, f32 on the card -> its flat
    decode-ordered vector."""
    for k in PAIR_TENSORS:
        _check(tuple(scale[k].shape) == tuple(like[k].shape),
               f"scale[{k}]: shape {tuple(scale[k].shape)} != "
               f"{tuple(like[k].shape)}")
        _check(scale[k].dtype == torch.float32,
               f"scale[{k}]: dtype {scale[k].dtype} != torch.float32")
        _check(scale[k].is_cuda, f"scale[{k}] is not a CUDA tensor")
    return _flat_scale(scale).contiguous()


def decode_pair_rng(base: dict, scale: dict, seeds, feats: torch.Tensor,
                    seq_length: int = 16, dtype=torch.float32,
                    need_logprobs: bool = False):
    """K5: both signs of antithetic pairs, each pair's f32 delta ``scale *
    N(0, 1)`` drawn in the kernel from its uint32 seed. base, scale: f32
    dicts (unbatched, shared by the pairs; scale's pad lanes 0); seeds: one
    host seed or P of them; feats (B, F) or (P, B, F). Returns (seq, lp) of
    shape (2, B, T) or (P, 2, B, T); index 0 is +delta. Tokens and lp equal
    K2's fed ``pair_delta_dump(scale, seeds)`` bit for bit. As in the JAX
    package, the delta is f32 whatever ``tpu.delta_dtype`` says."""
    if not feats.is_cuda:
        return decode_pair_rng_plain(base, scale, seeds, feats, seq_length,
                                     dtype, need_logprobs)
    _check(dtype in _DTYPE_CODE, f"compute dtype {dtype} is not f32 or bf16")
    u32, single = _seeds_u32(seeds)
    P = u32.shape[0]
    if feats.dim() == 2:
        feats = feats[None].expand(P, *feats.shape)
    _, B, F = feats.shape
    _check(feats.shape[0] == P, f"feats lead {feats.shape[0]} != pairs {P}")
    _check(1 <= B <= KERNEL_WIDTH, f"batch {B} outside 1..{KERNEL_WIDTH}")
    Vpad = _check_params({k: v[None] for k, v in base.items()}, 1, F,
                         torch.float32, what="base")
    flat = _check_scale(scale, base)
    feats = feats.to(dtype).contiguous()
    dev = feats.device
    _check(dev == base["img_w"].device == flat.device,
           "feats, base and scale on different devices")
    seq = torch.empty((P, 2, B, seq_length), dtype=torch.int32, device=dev)
    lp = torch.empty((P, 2, B, seq_length), dtype=torch.float32, device=dev)
    # each CTA's own copy of its pair's delta (csrc/decode.cu, K5's note)
    scratch = torch.empty((P, 2, flat.shape[0]), dtype=torch.float32,
                          device=dev)
    seeds_d = _seeds_on(u32, dev)
    err = _kernels().nes_decode_pair_rng(
        _DTYPE_CODE[dtype], int(need_logprobs), P, B, F, Vpad, seq_length,
        feats.data_ptr(), *(base[k].data_ptr() for k in PAIR_TENSORS),
        flat.data_ptr(), seeds_d.data_ptr(), scratch.data_ptr(),
        seq.data_ptr(), lp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "decode_pair_rng")
    decode_pair_rng.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_pair_rng.launches = 0


def pair_delta_dump(scale: dict, seeds) -> dict:
    """K7: the f32 delta K5 and K6 realize for each seed, all seeds in one
    launch. scale: f32 dict (pad lanes 0); seeds: one host seed or P of
    them. Returns a dict shaped like ``scale``, with a leading P axis unless
    a single seed was given."""
    if not scale["img_w"].is_cuda:
        return pair_delta_dump_plain(scale, seeds)
    flat = _check_scale(scale, scale)
    u32, single = _seeds_u32(seeds)
    P, dim = u32.shape[0], flat.shape[0]
    out = torch.empty((P, dim), dtype=torch.float32, device=flat.device)
    seeds_d = _seeds_on(u32, flat.device)
    err = _kernels().nes_pair_delta_dump(
        P, dim, flat.data_ptr(), seeds_d.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream)
    _raise_on(err, "pair_delta_dump")
    pair_delta_dump.launches += 1
    return _as_dict(out[0] if single else out, scale)


pair_delta_dump.launches = 0


def pair_grad_rng(scale: dict, seeds, weights) -> dict:
    """K6: ``sum_i weights[i] * delta(seeds[i])`` with every delta drawn
    again from its seed, summed over the pairs in order (deterministic, no
    atomics). scale: f32 dict (pad lanes 0); seeds: F host seeds; weights:
    F f32 (pad lanes 0). Returns an f32 dict shaped like ``scale``."""
    if not scale["img_w"].is_cuda:
        return pair_grad_rng_plain(scale, seeds, weights)
    flat = _check_scale(scale, scale)
    u32, _ = _seeds_u32(seeds)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=flat.device).reshape(-1).contiguous()
    _check(w.shape[0] == u32.shape[0],
           f"{w.shape[0]} weights for {u32.shape[0]} seeds")
    out = torch.empty_like(flat)
    seeds_d = _seeds_on(u32, flat.device)
    err = _kernels().nes_pair_grad_rng(
        u32.shape[0], flat.shape[0], flat.data_ptr(), seeds_d.data_ptr(),
        w.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream)
    _raise_on(err, "pair_grad_rng")
    pair_grad_rng.launches += 1
    return _as_dict(out, scale)


pair_grad_rng.launches = 0


def philox_words(seed: int, n: int, device) -> torch.Tensor:
    """(n, 4) int64: the uint32 words of Philox4x32-10 counters 0..n-1
    under key (seed, 0), from the kernels' generator on a CUDA device and
    from the plain one (ops/noise.py) on the CPU — the check that the two
    draw the same bits."""
    device = torch.device(device)
    if device.type != "cuda":
        q = torch.arange(n, device=device)
        z = torch.zeros_like(q)
        return torch.stack(philox4x32_10([q, z, z, z], (int(seed), 0)), -1)
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    err = _kernels().nes_philox_words(
        int(seed) & 0xFFFFFFFF, n, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "philox_words")
    return out.to(torch.int64) & 0xFFFFFFFF

