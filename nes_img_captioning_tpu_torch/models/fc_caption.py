"""FC image-captioning model (port of ``nes_img_captioning_tpu/models/fc_caption.py``).

An LSTM decoder over one image feature (reference: src/captioning/nets.py,
FCModel + LSTMCore): ``img_embed`` Linear(F -> E), ``embed``
Embedding(V+1 -> E), ``logit`` Linear(R -> V+1), and a single maxout-LSTM
``core`` whose fused i2h/h2h projections give 5R pre-activations: three
sigmoid gates and a maxout candidate max(chunk4, chunk5).

Three norm variants (reference: src/captioning/nets.py:89-165): ``vbn``
normalizes the i2h and h2h projections and the cell state before its tanh
with batch statistics (``core.{i2h,h2h,c}_bn``), ``layer_n`` with a
LayerNorm (``core.*_ln``), and ``vbn_e`` wraps ``img_embed`` and ``embed``
in a Sequential with a batch-statistics norm (``img_embed.0/.1``,
``embed.0/.1``); ``vbn_affine`` and ``layer_n_affine`` give the norms their
weight and bias leaves.

The module's ``state_dict`` keys and order are the spec's leaves, so its
``.pth`` is the reference format.

``sample_members`` is the eager rollout of M members at once (the JAX
``sample``, a ``lax.scan`` per member): the t=0 image step warms the state
and its token is discarded, then ``seq_length`` token steps from <bos> 0. A
row's token is masked to 0 once it has emitted 0, and a member's logprobs
stop being written one step after its whole batch finished (the
reference's ``break``). Each member's products are one ``baddbmm`` over the
member axis and its embedding a gather of its own table; batch statistics
are each member's own, over all of its rows, at every step. ``sample`` is
its greedy one-member form, on the module's own weights; the decode
kernels are held to it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .params import (
    Leaf,
    ParamSpec,
    batch_stat_norm,
    layer_norm,
    managed_linear,
    norm_leaves,
)
from ..utils.device import resolve_device

__all__ = ["FCModelOptions", "FCCaptionModel", "build_spec"]


@dataclasses.dataclass(frozen=True)
class FCModelOptions:
    """Mirror of the reference ModelOptions fields the FC model consumes
    (reference: src/algorithm/policies.py:36-41)."""

    vocab_size: int
    input_encoding_size: int = 128
    rnn_size: int = 128
    fc_feat_size: int = 2048
    seq_length: int = 16
    vbn: bool = False
    vbn_e: bool = False
    vbn_affine: bool = False
    layer_n: bool = False
    layer_n_affine: bool = False


def build_spec(o: FCModelOptions) -> ParamSpec:
    """Leaf order of the JAX ``_build_spec`` (torch module insertion order)."""
    V1 = o.vocab_size + 1
    E, R, F = o.input_encoding_size, o.rnn_size, o.fc_feat_size
    leaves: list[Leaf] = []
    if o.vbn_e:
        leaves += managed_linear("img_embed.0", E, F)
        leaves += norm_leaves("img_embed.1", E, o.vbn_affine)
        leaves += [Leaf("embed.0.weight", (V1, E), "xavier_normal")]
        leaves += norm_leaves("embed.1", E, o.vbn_affine)
    else:
        leaves += managed_linear("img_embed", E, F)
        leaves += [Leaf("embed.weight", (V1, E), "xavier_normal")]
    leaves += managed_linear("logit", V1, R)
    leaves += managed_linear("core.i2h", 5 * R, E)
    leaves += managed_linear("core.h2h", 5 * R, R)
    if o.vbn:
        leaves += norm_leaves("core.i2h_bn", 5 * R, o.vbn_affine)
        leaves += norm_leaves("core.h2h_bn", 5 * R, o.vbn_affine)
        leaves += norm_leaves("core.c_bn", R, o.vbn_affine)
    elif o.layer_n:
        leaves += norm_leaves("core.i2h_ln", 5 * R, o.layer_n_affine)
        leaves += norm_leaves("core.h2h_ln", 5 * R, o.layer_n_affine)
        leaves += norm_leaves("core.c_ln", R, o.layer_n_affine)
    return ParamSpec(tuple(leaves))


def _dense(x, w, b):
    """x @ w.T + b in torch's (out, in) layout: ``F.linear`` for one theta's
    leaves, one ``baddbmm`` over the member axis for members' leaves w (M,
    out, in), b (M, out) and x (M, R, in)."""
    if w.dim() == 2:
        return F.linear(x, w, b)
    return torch.baddbmm(b.unsqueeze(-2), x, w.transpose(-1, -2))


def _norm_params(p, name):
    """(weight, bias) of a norm, None where it has no affine leaves."""
    return p.get(name + ".weight"), p.get(name + ".bias")


def _batch_norm(n: int, affine: bool, device):
    return nn.BatchNorm1d(n, affine=affine, track_running_stats=False,
                          device=device)


class _LSTMCore(nn.Module):
    def __init__(self, o: FCModelOptions, device):
        super().__init__()
        E, R = o.input_encoding_size, o.rnn_size
        self.i2h = nn.utils.skip_init(nn.Linear, E, 5 * R, device=device)
        self.h2h = nn.utils.skip_init(nn.Linear, R, 5 * R, device=device)
        for kind, n in (("i2h", 5 * R), ("h2h", 5 * R), ("c", R)):
            if o.vbn:
                setattr(self, f"{kind}_bn", _batch_norm(n, o.vbn_affine,
                                                        device))
            elif o.layer_n:
                setattr(self, f"{kind}_ln", nn.LayerNorm(
                    n, elementwise_affine=o.layer_n_affine, device=device))


class FCCaptionModel(nn.Module):
    """The FC captioner as an ``nn.Module``. Weights come from ``theta`` (a
    flat spec-ordered tensor) or from ``spec.init_theta(generator)``; with
    ``device="meta"`` the module carries the spec and no storage."""

    def __init__(self, options: FCModelOptions, theta: torch.Tensor | None
                 = None, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        o = options
        device = resolve_device(device)
        self.options = o
        self.spec = build_spec(o)
        V1, E, R, F = (o.vocab_size + 1, o.input_encoding_size, o.rnn_size,
                       o.fc_feat_size)
        # registration order == spec leaf order == state_dict order
        img_embed = nn.utils.skip_init(nn.Linear, F, E, device=device)
        embed = nn.utils.skip_init(nn.Embedding, V1, E, device=device)
        if o.vbn_e:
            img_embed = nn.Sequential(img_embed,
                                      _batch_norm(E, o.vbn_affine, device))
            embed = nn.Sequential(embed, _batch_norm(E, o.vbn_affine, device))
        self.img_embed, self.embed = img_embed, embed
        self.logit = nn.utils.skip_init(nn.Linear, R, V1, device=device)
        self.core = _LSTMCore(o, device)
        if device.type == "meta":
            return
        if theta is None:
            if generator is None:
                raise ValueError("pass theta or a torch.Generator to init from")
            theta = self.spec.init_theta(generator, device=device)
        self.load_theta(theta)

    @property
    def num_params(self) -> int:
        return self.spec.num_params

    @torch.no_grad()
    def load_theta(self, theta: torch.Tensor):
        """Copy a flat spec-ordered theta into the module's parameters."""
        shaped = self.spec.unravel(theta.detach())
        for name, p in self.named_parameters():
            p.copy_(shaped[name])

    def theta(self) -> torch.Tensor:
        return self.spec.ravel(dict(self.named_parameters())).detach()

    # ---- the layers on a params dict (one theta's leaves, or members') -------
    # (JAX: fc_caption.py:121-168)

    def _maybe_norm(self, p, x, kind: str):
        """The core's norm of the i2h or h2h projection or the cell state,
        if the variant has one."""
        o = self.options
        if o.vbn:
            return batch_stat_norm(x, *_norm_params(p, f"core.{kind}_bn"))
        if o.layer_n:
            return layer_norm(x, *_norm_params(p, f"core.{kind}_ln"))
        return x

    def _img_embed(self, p, fc_feats):
        if self.options.vbn_e:
            return batch_stat_norm(
                _dense(fc_feats, p["img_embed.0.weight"],
                       p["img_embed.0.bias"]), *_norm_params(p, "img_embed.1"))
        return _dense(fc_feats, p["img_embed.weight"], p["img_embed.bias"])

    def _embed(self, p, it, onehot: bool = False):
        """The embedding rows of tokens ``it``: gathered from each member's
        own table, or with ``onehot`` (one theta) read as an exact f32
        one-hot product outside any autocast."""
        vbn_e = self.options.vbn_e
        w = p["embed.0.weight" if vbn_e else "embed.weight"]
        if onehot:
            with torch.autocast(w.device.type, enabled=False):
                vocab = torch.arange(w.shape[0], device=w.device)
                y = (it[:, None] == vocab).to(w.dtype) @ w
        elif w.dim() == 3:
            y = w[torch.arange(w.shape[0], device=w.device)[:, None], it]
        else:
            y = w[it]
        return batch_stat_norm(y, *_norm_params(p, "embed.1")) if vbn_e else y

    def lstm_core(self, p, xt, h, c):
        """One fused maxout-LSTM step: three sigmoid gates and the
        candidate max(chunk4, chunk5) of the 5R pre-activations, the norms
        on i2h, on h2h and on c before its tanh. Returns (output, h',
        c')."""
        R = self.options.rnn_size
        a = (self._maybe_norm(p, _dense(xt, p["core.i2h.weight"],
                                        p["core.i2h.bias"]), "i2h")
             + self._maybe_norm(p, _dense(h, p["core.h2h.weight"],
                                          p["core.h2h.bias"]), "h2h"))
        gates = torch.sigmoid(a[..., : 3 * R])
        in_gate, forget_gate, out_gate = (gates[..., :R], gates[..., R:2 * R],
                                          gates[..., 2 * R:3 * R])
        in_transform = torch.maximum(a[..., 3 * R:4 * R], a[..., 4 * R:5 * R])
        next_c = forget_gate * c + in_gate * in_transform
        next_h = out_gate * torch.tanh(self._maybe_norm(p, next_c, "c"))
        return next_h, next_h, next_c

    def _logprobs(self, p, out):
        return torch.log_softmax(
            _dense(out, p["logit.weight"], p["logit.bias"]), dim=-1)

    # ---- rollout ---------------------------------------------------------------

    @torch.no_grad()
    def sample_members(self, thetas: torch.Tensor, feats: torch.Tensor,
                       greedy: bool = True, gumbel=None):
        """Decode M members at once, f32 (JAX: fc_caption.py:175-226, once
        per member). thetas (M, dim) flat, feats (M, R, F): member m's R
        rows. Greedy takes the argmax (first index on ties) and its
        logprob. Sampling takes ``argmax(logprobs + g)``, JAX's
        ``jax.random.categorical``, and the logprob of that token; ``g`` is
        ``gumbel(t)`` for a callable, else ``gumbel[:, t]`` of an (M, T, R,
        V) table, its first V+1 columns. Returns (seq (M, R, T) int32, lp
        (M, R, T) f32)."""
        o = self.options
        p = self.spec.unravel(thetas.to(torch.float32))
        M, R = feats.shape[:2]
        V1, dev = o.vocab_size + 1, feats.device
        h = c = torch.zeros((M, R, o.rnn_size), device=dev)
        # t=0: image step (its token is discarded by the reference too)
        _, h, c = self.lstm_core(p, self._img_embed(p, feats.to(torch.float32)),
                                 h, c)
        it = torch.zeros((M, R), dtype=torch.long, device=dev)  # <bos> = 0
        unfinished = torch.ones((M, R), dtype=torch.bool, device=dev)
        active = torch.ones((M, 1), dtype=torch.bool, device=dev)
        seq, seq_lp = [], []
        for t in range(o.seq_length):
            out, h, c = self.lstm_core(p, self._embed(p, it), h, c)
            logprobs = self._logprobs(p, out)
            if greedy:
                lp = logprobs.max(dim=-1).values
                it_new = logprobs.argmax(dim=-1)  # first index on ties
            else:
                g = gumbel(t) if callable(gumbel) else gumbel[:, t]
                it_new = (logprobs + g[..., :V1]).argmax(dim=-1)
                lp = logprobs.gather(-1, it_new[..., None])[..., 0]
            unfinished = unfinished & (it_new > 0)
            it = torch.where(unfinished, it_new, 0)
            seq.append(it.to(torch.int32))
            seq_lp.append(torch.where(active, lp, 0.0))
            active = active & unfinished.any(-1, keepdim=True)
        return torch.stack(seq, -1), torch.stack(seq_lp, -1)

    def sample(self, fc_feats: torch.Tensor):
        """Greedy decode of feats (B, F) on the module's weights: (seq [B,
        T] int32, seq_logprobs [B, T] f32), token for token the reference
        FCModel._sample (src/captioning/nets.py:183-245) in greedy mode."""
        seq, lp = self.sample_members(self.theta()[None], fc_feats[None])
        return seq[0], lp[0]

    # ---- sensitivity forward ----------------------------------------------

    def forward_for_sensitivity(self, theta: torch.Tensor, fc_feats,
                                length: int = 5, split: int = 100):
        """Grouped-logprob output (B, K) for the SM-G sensitivities, a
        differentiable function of the flat theta (JAX: fc_caption.py:
        228-255; reference: src/captioning/nets.py:22-70): the image step,
        then ``length`` greedy steps from <bos>, the argmax fed back as data
        (detached); the last step's logprobs padded and grouped into L2
        norms of ``split`` columns. The pad is always ``split - (V+1) %
        split``, so a vocab that divides evenly gets a whole extra zero group
        (the reference's quirk): K = (V+1) // split + 1. The norms run as
        in the rollout; vbn's statistics are over the B rows of this one
        theta, so an outer ``vmap`` over parents keeps each parent's own.

        The embedding is read as a one-hot product, in f32 outside any
        autocast, so the row is exact. Its backward is a product too,
        whose sums do not depend on where the tokens sit among those of
        other parents in an outer ``vmap``; the embedding's own backward
        sums a row's gradient in warp-sized batches of token positions, and
        ``weight[it]`` scatters it with atomics."""
        p = self.spec.unravel(theta)
        B = fc_feats.shape[0]
        h = c = theta.new_zeros((B, self.options.rnn_size))
        _, h, c = self.lstm_core(p, self._img_embed(p, fc_feats), h, c)
        it = torch.zeros((B,), dtype=torch.long, device=theta.device)
        for _ in range(length):
            out, h, c = self.lstm_core(p, self._embed(p, it, onehot=True), h,
                                       c)
            logprobs = self._logprobs(p, out)
            it = logprobs.detach().argmax(dim=-1)
        n = logprobs.shape[-1]
        pad = split - n % split
        groups = F.pad(logprobs, (0, pad)).reshape(B, (n + pad) // split,
                                                   split)
        return torch.sqrt((groups ** 2).sum(-1))
