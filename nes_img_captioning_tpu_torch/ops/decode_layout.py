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

Width pads (``pad=True``, which the card always takes) lay a model of any E,
R <= 1024 and any F out at the kernels' shape ``kernel_shape(E, R, F)``: E
and R padded to W, the smallest built width at least max(E, R), and F to
the next multiple of 128. Every width pad holds 0, in theta and in every
noise scale, and the 5R gate axis is padded per gate block (gate g's cell j
at column g * W + j, where the kernels read gate g). A pad cell's gate
pre-activations are then 0, its c and h stay exactly 0 at every step, and
the pads change no real output: the decode is the unpadded model's.
``from_dec`` drops them with the vocab pads.
"""

from __future__ import annotations

import numpy as np
import torch

from .decode_cuda import NEG, kernel_shape, pad_vocab

__all__ = ["DecodeLayout"]

# the LSTM's gate blocks along the 5R axis (i, f, o and the two maxout
# candidates)
GATES = 5


class DecodeLayout:
    """Flat decode-ordered layout for the (no-norm) FC captioning model, in
    the tensor order of prepare_decode_params' dict. ``pad``: the kernels'
    widths (``kernel_shape``) instead of the model's own E, R and F."""

    def __init__(self, spec, options, pad: bool = False):
        V1 = options.vocab_size + 1
        Vpad = pad_vocab(V1)
        E, R, F = (options.input_encoding_size, options.rnn_size,
                   options.fc_feat_size)
        W, F_k = kernel_shape(E, R, F) if pad else (None, F)
        self.spec = spec
        self.V1, self.Vpad = V1, Vpad
        # each axis's size in the model and in the layout: F features, E
        # embedding, R cells, G the gate axis (GATES blocks of R cells), V
        # the vocab, 1 a bias's row
        self.true = {"F": F, "E": E, "R": R, "G": R, "V": V1, "1": 1}
        self.sizes = {"F": F_k, "E": W or E, "R": W or R, "G": W or R,
                      "V": Vpad, "1": 1}
        # (decode name, source leaf, axes, transposed?, vocab pad value)
        self.tensors = (
            ("img_w", "img_embed.weight", "FE", True, 0.0),
            ("img_b", "img_embed.bias", "1E", False, 0.0),
            ("i2h_w", "core.i2h.weight", "EG", True, 0.0),
            ("i2h_b", "core.i2h.bias", "1G", False, 0.0),
            ("h2h_w", "core.h2h.weight", "RG", True, 0.0),
            ("h2h_b", "core.h2h.bias", "1G", False, 0.0),
            ("logit_w", "logit.weight", "RV", True, 0.0),
            ("logit_b", "logit.bias", "1V", False, NEG),
            ("embed", "embed.weight", "VE", False, 0.0),
        )
        self._offsets = {}
        off = 0
        for name, _, axes, *_ in self.tensors:
            self._offsets[name] = off
            off += int(np.prod(self.shape(axes)))
        self.dim_dec = off

    def shape(self, axes: str, sizes: dict | None = None) -> tuple:
        """A tensor's shape in the layout (or at ``sizes``, e.g. ``true``)."""
        sizes = self.sizes if sizes is None else sizes
        return tuple(sizes[a] * (GATES if a == "G" else 1) for a in axes)

    def _pad(self, t: torch.Tensor, axes: str, vocab_pad: float
             ) -> torch.Tensor:
        """(..., *true shape) -> (..., *layout shape): each axis padded at
        its end, the gate axis at the end of each gate block; the vocab pads
        hold ``vocab_pad``, every width pad 0."""
        nF = torch.nn.functional
        for i, a in enumerate(axes):
            n, m = self.true[a], self.sizes[a]
            if n == m:
                continue
            after = (0, 0) * (len(axes) - 1 - i)
            value = vocab_pad if a == "V" else 0.0
            if a == "G":  # the last axis: (..., GATES, R) padded per block
                t = nF.pad(t.reshape(*t.shape[:-1], GATES, n), (0, m - n),
                           value=value).reshape(*t.shape[:-1], GATES * m)
            else:
                t = nF.pad(t, after + (0, m - n), value=value)
        return t

    def _unpad(self, t: torch.Tensor, axes: str) -> torch.Tensor:
        """Inverse of ``_pad``: (..., *layout shape) -> (..., *true shape)."""
        for i, a in enumerate(axes):
            n, m = self.true[a], self.sizes[a]
            if n == m:
                continue
            if a == "G":
                t = t.reshape(*t.shape[:-1], GATES, m)[..., :n].reshape(
                    *t.shape[:-1], GATES * n)
            else:
                t = t.narrow(t.dim() - len(axes) + i, 0, n)
        return t

    # ---- flat torch order <-> flat decode order --------------------------------------

    def to_dec(self, flat: torch.Tensor, pad_scale: float = 1.0
               ) -> torch.Tensor:
        """Flat torch-order vector(s) (..., dim) -> flat decode-ordered
        padded f32 (..., dim_dec), with the same leading axes (the ES sweep
        lays out a chunk of children at once; every step is a copy, so a
        row's bits do not depend on the rows beside it). ``pad_scale``
        scales each tensor's vocab pad value (1 for theta, so the padded
        logit bias is NEG; 0 for noise-scale vectors); width pads are 0
        either way."""
        lead = flat.shape[:-1]
        leaves = {l.name: l for l in self.spec.leaves}
        parts = []
        for _, leaf, axes, transposed, pad_val in self.tensors:
            off, spec_leaf = self.spec.offset(leaf), leaves[leaf]
            t = flat[..., off:off + spec_leaf.size].reshape(
                *lead, *spec_leaf.shape)
            if transposed:
                t = t.transpose(-1, -2)
            t = self._pad(t.reshape(*lead, *self.shape(axes, self.true)),
                          axes, pad_val * pad_scale)
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
        for name, leaf, axes, transposed, _ in self.tensors:
            off, shape = self._offsets[name], self.shape(axes)
            t = self._unpad(flat_dec[..., off:off + int(np.prod(shape))]
                            .reshape(*lead, *shape), axes)
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
        for name, _, axes, *_ in self.tensors:
            off, shape = self._offsets[name], self.shape(axes)
            t = vec_dec[..., off:off + int(np.prod(shape))].reshape(
                *lead, *shape)
            out[name] = (t.to(torch.float32) if name.endswith("_b")
                         else t.to(dtype)).contiguous()
        return out
