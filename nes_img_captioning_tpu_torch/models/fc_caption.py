"""FC image-captioning model (port of ``nes_img_captioning_tpu/models/fc_caption.py``).

An LSTM decoder over one image feature (reference: src/captioning/nets.py,
FCModel + LSTMCore): ``img_embed`` Linear(F -> E), ``embed``
Embedding(V+1 -> E), ``logit`` Linear(R -> V+1), and a single maxout-LSTM
``core`` whose fused i2h/h2h projections give 5R pre-activations: three
sigmoid gates and a maxout candidate max(chunk4, chunk5).

The module's ``state_dict`` keys and order are the spec's leaves, so its
``.pth`` is the reference format. This slice ports the no-norm model; the
vbn and layer_n variants raise ``NotImplementedError``.

``sample`` is the eager greedy rollout the decode kernels are held to: the
t=0 image step warms the state and its token is discarded, then
``seq_length`` token steps. A row's token is masked to 0 once it has emitted
0, and logprobs stop being written one step after the whole batch finished
(the reference's ``break``), exactly as the JAX ``lax.scan`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .params import Leaf, ParamSpec, managed_linear, norm_leaves
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


def _maxout_cell(a, c, R: int):
    """The maxout-LSTM cell on the 5R pre-activations ``a``: three sigmoid
    gates and the candidate max(chunk4, chunk5). Returns (h', c')."""
    gates = torch.sigmoid(a[..., : 3 * R])
    in_gate, forget_gate, out_gate = (gates[..., :R], gates[..., R:2 * R],
                                      gates[..., 2 * R:3 * R])
    in_transform = torch.maximum(a[..., 3 * R:4 * R], a[..., 4 * R:5 * R])
    next_c = forget_gate * c + in_gate * in_transform
    return out_gate * torch.tanh(next_c), next_c


class _LSTMCore(nn.Module):
    def __init__(self, E: int, R: int, device):
        super().__init__()
        self.i2h = nn.utils.skip_init(nn.Linear, E, 5 * R, device=device)
        self.h2h = nn.utils.skip_init(nn.Linear, R, 5 * R, device=device)


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
        if o.vbn or o.vbn_e or o.layer_n:
            raise NotImplementedError(
                "the vbn / layer_n FC variants are not ported yet")
        self.options = o
        self.spec = build_spec(o)
        V1, E, R, F = (o.vocab_size + 1, o.input_encoding_size, o.rnn_size,
                       o.fc_feat_size)
        # registration order == spec leaf order == state_dict order
        self.img_embed = nn.utils.skip_init(nn.Linear, F, E, device=device)
        self.embed = nn.utils.skip_init(nn.Embedding, V1, E, device=device)
        self.logit = nn.utils.skip_init(nn.Linear, R, V1, device=device)
        self.core = _LSTMCore(E, R, device)
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

    # ---- core step -----------------------------------------------------------

    def lstm_core(self, xt, h, c):
        """One fused maxout-LSTM step. Returns (output, h', c')."""
        next_h, next_c = _maxout_cell(self.core.i2h(xt) + self.core.h2h(h),
                                      c, self.options.rnn_size)
        return next_h, next_h, next_c

    # ---- rollout ---------------------------------------------------------------

    @torch.no_grad()
    def sample(self, fc_feats: torch.Tensor):
        """Greedy decode. Returns (seq [B, T] int32, seq_logprobs [B, T] f32),
        token for token the reference FCModel._sample
        (src/captioning/nets.py:183-245) in greedy mode. Sampled decoding
        is not ported yet."""
        o = self.options
        B, T = fc_feats.shape[0], o.seq_length
        dev = fc_feats.device
        h = torch.zeros((B, o.rnn_size), device=dev)
        c = torch.zeros((B, o.rnn_size), device=dev)
        # t=0: image step (its token is discarded by the reference too)
        _, h, c = self.lstm_core(self.img_embed(fc_feats), h, c)

        it = torch.zeros((B,), dtype=torch.long, device=dev)  # <bos> = 0
        unfinished = torch.ones((B,), dtype=torch.bool, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        seq, seq_lp = [], []
        for _ in range(T):
            out, h, c = self.lstm_core(self.embed.weight[it], h, c)
            logprobs = torch.log_softmax(self.logit(out), dim=-1)
            lp = logprobs.max(dim=-1).values
            it_new = logprobs.argmax(dim=-1)  # first index on ties
            unfinished = unfinished & (it_new > 0)
            it = torch.where(unfinished, it_new, 0)
            seq.append(it.to(torch.int32))
            seq_lp.append(torch.where(active, lp, 0.0))
            active = active & unfinished.any()
        return torch.stack(seq, 1), torch.stack(seq_lp, 1)

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
        (the reference's quirk): K = (V+1) // split + 1.

        The embedding is read as a one-hot product, in f32 outside any
        autocast, so the row is exact. Its backward is a product too,
        whose sums do not depend on where the tokens sit among those of
        other parents in an outer ``vmap``; the embedding's own backward
        sums a row's gradient in warp-sized batches of token positions, and
        ``weight[it]`` scatters it with atomics."""
        p = self.spec.unravel(theta)
        R = self.options.rnn_size
        B = fc_feats.shape[0]
        vocab = torch.arange(p["embed.weight"].shape[0], device=theta.device)

        def embed(it):
            with torch.autocast(theta.device.type, enabled=False):
                onehot = (it[:, None] == vocab).to(theta.dtype)
                return onehot @ p["embed.weight"]

        def core(xt, h, c):
            a = (F.linear(xt, p["core.i2h.weight"], p["core.i2h.bias"])
                 + F.linear(h, p["core.h2h.weight"], p["core.h2h.bias"]))
            return _maxout_cell(a, c, R)

        h = c = theta.new_zeros((B, R))
        h, c = core(F.linear(fc_feats, p["img_embed.weight"],
                             p["img_embed.bias"]), h, c)
        it = torch.zeros((B,), dtype=torch.long, device=theta.device)
        for _ in range(length):
            h, c = core(embed(it), h, c)
            logprobs = torch.log_softmax(
                F.linear(h, p["logit.weight"], p["logit.bias"]), dim=-1)
            it = logprobs.detach().argmax(dim=-1)
        n = logprobs.shape[-1]
        pad = split - n % split
        groups = F.pad(logprobs, (0, pad)).reshape(B, (n + pad) // split,
                                                   split)
        return torch.sqrt((groups ** 2).sum(-1))
