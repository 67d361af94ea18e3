"""Small MNIST CNN (port of ``nes_img_captioning_tpu/models/mnist.py``).

Reference: src/classification/nets.py — conv(1->10, 5) -> [bn] -> relu ->
maxpool2 -> conv(10->20, 5) -> [bn] -> relu -> maxpool2 -> fc(320->10).
Parameters whose name contains '1' keep torch-default init (the reference's
managed-init quirk, src/algorithm/nets.py:62-69): conv1 and fc1 (and bn1),
while conv2 gets xavier_normal weights and a zero bias. With ``vbn`` each
conv is followed by a batch norm over the batch's own statistics
(BatchNorm2d with track_running_stats=False): 8,490 parameters, 8,550 with
vbn, in the spec order of the JAX package, so a ``.pth`` crosses between
the packages.

``forward_members`` runs M members at once, each on its own batch of
images: the members' channels sit side by side in one tensor (member m in
channel block m), each convolution is one grouped convolution with
``groups=M``, a batch norm takes each member's statistics over its own
batch (the channel axis already separates the members), and the dense layer
is one batched product.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .params import Leaf, ParamSpec, norm_leaves
from ..utils.device import resolve_device

__all__ = ["MnistModelOptions", "MnistModel", "build_spec"]


@dataclasses.dataclass(frozen=True)
class MnistModelOptions:
    vbn: bool = False


def build_spec(o: MnistModelOptions) -> ParamSpec:
    """Leaf order of the JAX ``_build_spec`` (torch module insertion
    order)."""
    leaves = [
        Leaf("conv1.weight", (10, 1, 5, 5), "kaiming_uniform"),
        Leaf("conv1.bias", (10,), "uniform_fan", init_fan=1 * 5 * 5),
        Leaf("conv2.weight", (20, 10, 5, 5), "xavier_normal"),
        Leaf("conv2.bias", (20,), "zeros"),
        Leaf("fc1.weight", (10, 320), "kaiming_uniform"),
        Leaf("fc1.bias", (10,), "uniform_fan", init_fan=320),
    ]
    if o.vbn:
        leaves += norm_leaves("bn1", 10, affine=True)
        leaves += norm_leaves("bn2", 20, affine=True)
    return ParamSpec(tuple(leaves))


def _unravel_rows(spec: ParamSpec, thetas: torch.Tensor) -> dict:
    """(M, dim) flat thetas -> {leaf name: (M, *shape)}."""
    pieces = thetas.split([l.size for l in spec.leaves], dim=-1)
    return {l.name: t.reshape(t.shape[0], *l.shape)
            for l, t in zip(spec.leaves, pieces)}


def _conv(h, w, b):
    """Valid stride-1 convolution of every member at once: h (B, M * Cin,
    H, W), w (M, Cout, Cin, k, k), b (M, Cout) -> (B, M * Cout, H', W'),
    member m's output in channel block m. Under a bf16 autocast the
    product takes bf16 operands and its result comes back as f32, so what
    follows (the batch norm's statistics) stays f32."""
    return F.conv2d(h, w.reshape(-1, *w.shape[2:]), b.reshape(-1),
                    groups=w.shape[0]).float()


def _bn2d(h, w, b):
    """BatchNorm2d(track_running_stats=False) as the JAX package writes it:
    mean and biased variance over (N, H, W) of each channel, so of each
    member's own batch, then ``(x - mean) * rsqrt(var + 1e-5)`` and the
    affine (w, b (M, C))."""
    mean = h.mean(dim=(0, 2, 3), keepdim=True)
    var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    y = (h - mean) * torch.rsqrt(var + 1e-5)
    return y * w.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)


class MnistModel(nn.Module):
    """The MNIST CNN as an ``nn.Module``. Weights come from ``theta`` (a
    flat spec-ordered tensor) or from ``spec.init_theta(generator)``; with
    ``device="meta"`` the module carries the spec and no storage. The
    population paths call ``forward_members`` on flat thetas."""

    def __init__(self, options: MnistModelOptions = MnistModelOptions(),
                 theta: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.options = options
        self.spec = build_spec(options)
        # registration order == spec leaf order == state_dict order
        self.conv1 = nn.utils.skip_init(nn.Conv2d, 1, 10, 5, device=device)
        self.conv2 = nn.utils.skip_init(nn.Conv2d, 10, 20, 5, device=device)
        self.fc1 = nn.utils.skip_init(nn.Linear, 320, 10, device=device)
        if options.vbn:
            self.bn1 = nn.BatchNorm2d(10, track_running_stats=False,
                                      device=device)
            self.bn2 = nn.BatchNorm2d(20, track_running_stats=False,
                                      device=device)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (B, 10) of the module's own weights on x (B, 1, 28, 28)."""
        theta = self.spec.ravel(dict(self.named_parameters()))
        return self.forward_members(theta[None], x[None])[0]

    def forward_members(self, thetas: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
        """Logits (M, B, 10) of M flat thetas (M, dim), member m on its own
        images x[m] (x (M, B, 1, 28, 28)). The flatten before fc1 is in
        CHW order, as torch's ``.view``."""
        p = _unravel_rows(self.spec, thetas)
        M, B = x.shape[:2]
        h = x.transpose(0, 1).reshape(B, M * x.shape[2], *x.shape[3:])
        h = _conv(h, p["conv1.weight"], p["conv1.bias"])
        if self.options.vbn:
            h = _bn2d(h, p["bn1.weight"], p["bn1.bias"])
        h = F.max_pool2d(F.relu(h), 2)
        h = _conv(h, p["conv2.weight"], p["conv2.bias"])
        if self.options.vbn:
            h = _bn2d(h, p["bn2.weight"], p["bn2.bias"])
        h = F.max_pool2d(F.relu(h), 2)
        h = h.reshape(B, M, -1).transpose(0, 1)  # (M, B, 320)
        return torch.baddbmm(p["fc1.bias"][:, None, :], h,
                             p["fc1.weight"].transpose(1, 2)).float()

    def forward_for_sensitivity(self, theta: torch.Tensor, x: torch.Tensor
                                ) -> torch.Tensor:
        """The SM-G output of one flat theta on x (B, 1, 28, 28): the raw
        logits (B, 10) (reference: src/classification/nets.py:39-48)."""
        return self.forward_members(theta[None], x[None])[0]
