"""Decode-ordered flat parameter layout (port of ``nes_img_captioning_tpu/ops/decode_layout.py``).

The canonical individual is a flat f32 vector in torch parameter order. The
decode kernels take weights pre-transposed to (in, out) and vocab-padded
(``prepare_decode_params``). ``to_dec`` lays theta (or the noise scale) out
once per generation in that order, so a member's prep is
``theta_dec ± delta_dec`` followed by slice / reshape / cast. The NES
gradient is summed in decode order and mapped back with the linear
``from_dec``.

Pad lanes (vocab rows/cols between vocab_size+1 and the 128 multiple) hold
``NEG`` in theta's logit bias and 0 elsewhere; the noise scale is laid out
with ``pad_scale=0``, so pads draw zero noise, the padded bias stays at
``NEG`` and argmax never emits a pad token.
"""

from __future__ import annotations

import numpy as np
import torch

from .decode_cuda import NEG, pad_vocab

__all__ = ["DecodeLayout"]


class DecodeLayout:
    """Flat decode-ordered layout for the (no-norm) FC captioning model, in
    the tensor order of prepare_decode_params' dict."""

    def __init__(self, spec, options):
        V1 = options.vocab_size + 1
        Vpad = pad_vocab(V1)
        E, R, F = (options.input_encoding_size, options.rnn_size,
                   options.fc_feat_size)
        self.spec = spec
        self.V1, self.Vpad = V1, Vpad
        # (decode name, source leaf, decode shape, transposed?, pad value,
        #  pad axis: None = unpadded, 0/1 = the vocab axis padded V1 -> Vpad)
        self.tensors = (
            ("img_w", "img_embed.weight", (F, E), True, 0.0, None),
            ("img_b", "img_embed.bias", (1, E), False, 0.0, None),
            ("i2h_w", "core.i2h.weight", (E, 5 * R), True, 0.0, None),
            ("i2h_b", "core.i2h.bias", (1, 5 * R), False, 0.0, None),
            ("h2h_w", "core.h2h.weight", (R, 5 * R), True, 0.0, None),
            ("h2h_b", "core.h2h.bias", (1, 5 * R), False, 0.0, None),
            ("logit_w", "logit.weight", (R, Vpad), True, 0.0, 1),
            ("logit_b", "logit.bias", (1, Vpad), False, NEG, 1),
            ("embed", "embed.weight", (Vpad, E), False, 0.0, 0),
        )
        self._offsets = {}
        off = 0
        for name, _, shape, *_ in self.tensors:
            self._offsets[name] = off
            off += int(np.prod(shape))
        self.dim_dec = off

    # ---- flat torch order <-> flat decode order --------------------------------------

    def to_dec(self, flat: torch.Tensor, pad_scale: float = 1.0
               ) -> torch.Tensor:
        """Flat torch-order vector(s) (..., dim) -> flat decode-ordered
        padded f32 (..., dim_dec), with the same leading axes (the ES sweep
        lays out a chunk of children at once; every step is a copy, so a
        row's bits do not depend on the rows beside it). ``pad_scale``
        scales each tensor's pad value (1 for theta, so the padded logit
        bias is NEG; 0 for noise-scale vectors)."""
        lead = flat.shape[:-1]
        leaves = {l.name: l for l in self.spec.leaves}
        parts = []
        for _, leaf, shape, transposed, pad_val, pad_axis in self.tensors:
            off, spec_leaf = self.spec.offset(leaf), leaves[leaf]
            t = flat[..., off:off + spec_leaf.size].reshape(
                *lead, *spec_leaf.shape)
            if transposed:
                t = t.transpose(-1, -2)
            if pad_axis is not None:
                t = t.reshape(*lead, shape[0] if pad_axis == 1 else self.V1,
                              -1)
                width = (0, self.Vpad - self.V1)
                t = torch.nn.functional.pad(
                    t, width + (0, 0) if pad_axis == 1 else (0, 0) + width,
                    value=pad_val * pad_scale)
            parts.append(t.reshape(*lead, -1).to(torch.float32))
        return torch.cat(parts, -1)

    def from_dec(self, flat_dec: torch.Tensor) -> torch.Tensor:
        """Flat decode-ordered vector(s) (..., dim_dec) -> flat torch order
        (..., dim), with the same leading axes (pads dropped, transposes
        undone). Linear, and every step a copy: a row's bits do not depend
        on the rows beside it, and ``to_dec`` restores the pads of a vector
        whose pads hold their pad values."""
        lead = flat_dec.shape[:-1]
        shaped = {}
        for name, leaf, shape, transposed, _, pad_axis in self.tensors:
            off = self._offsets[name]
            t = flat_dec[..., off:off + int(np.prod(shape))].reshape(
                *lead, *shape)
            if pad_axis == 1:
                t = t[..., : self.V1]
            elif pad_axis == 0:
                t = t[..., : self.V1, :]
            if transposed:
                t = t.transpose(-1, -2)
            shaped[leaf] = t
        return torch.cat([shaped[l.name].reshape(*lead, -1)
                          for l in self.spec.leaves], -1)

    def flat_dec(self, params: dict) -> torch.Tensor:
        """Inverse of ``prep``'s shaping: a params dict -> the flat
        decode-ordered f32 vector."""
        return torch.cat([params[name].to(torch.float32).reshape(-1)
                          for name, *_ in self.tensors])

    # ---- per-member prep --------------------------------------------------------------

    def prep(self, vec_dec: torch.Tensor, dtype) -> dict:
        """Decode-ordered vector(s) (..., dim_dec) -> the params dict the
        kernels take, with the same leading axes. Weights cast to ``dtype``,
        biases stay f32; equal tensor for tensor to prepare_decode_params
        when ``vec_dec`` is ``to_dec(theta)``."""
        lead = vec_dec.shape[:-1]
        out = {}
        for name, _, shape, *_ in self.tensors:
            off = self._offsets[name]
            t = vec_dec[..., off:off + int(np.prod(shape))].reshape(
                *lead, *shape)
            out[name] = (t.to(torch.float32) if name.endswith("_b")
                         else t.to(dtype)).contiguous()
        return out
