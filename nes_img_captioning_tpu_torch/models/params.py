"""Flat-parameter model substrate (port of ``nes_img_captioning_tpu/models/params.py``).

An individual is one flat float32 tensor ``theta`` whose element order is
torch's ``parameters_to_vector`` over the reference model's
``named_parameters()``; Linear weights keep the (out, in) layout. The leaf
order, offsets and ``num_params`` are those of the JAX package, so a theta
crosses between the two packages as a plain array
(``theta_from_numpy`` / ``theta_to_numpy``) and a ``.pth`` written by either
loads bit-exact in the other.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Leaf", "ParamSpec", "reference_init_kind", "torch_fans",
           "managed_linear", "norm_leaves", "theta_from_numpy",
           "theta_to_numpy"]


def torch_fans(shape: tuple[int, ...]) -> tuple[int, int]:
    """fan_in/fan_out following torch.nn.init._calculate_fan_in_and_fan_out."""
    if len(shape) < 2:
        raise ValueError(f"fan undefined for shape {shape}")
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One named parameter tensor; ``init`` kinds as in the JAX package:
    xavier_normal, zeros, ones, kaiming_uniform, uniform_fan, normal."""

    name: str
    shape: tuple[int, ...]
    init: str = "zeros"
    init_fan: int = 0  # fan_in used by 'uniform_fan'

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def reference_init_kind(name: str) -> bool:
    """Whether the reference "manages" this leaf's init: only names holding
    none of 'bn', 'ln', '1' (src/algorithm/nets.py:62-69), a quirk that also
    leaves e.g. MnistNet's conv1/fc1 at torch-default init."""
    return ("bn" not in name) and ("ln" not in name) and ("1" not in name)


def _init_leaf(leaf: Leaf, gen: torch.Generator, device) -> torch.Tensor:
    f32 = torch.float32
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=f32, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=f32, device=device)
    if leaf.init == "xavier_normal":
        fan_in, fan_out = torch_fans(leaf.shape)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return std * torch.randn(leaf.shape, generator=gen, dtype=f32,
                                 device=device)
    if leaf.init in ("kaiming_uniform", "uniform_fan"):
        fan = torch_fans(leaf.shape)[0] if leaf.init == "kaiming_uniform" \
            else max(leaf.init_fan, 1)
        bound = 1.0 / math.sqrt(fan)
        u = torch.rand(leaf.shape, generator=gen, dtype=f32, device=device)
        return (2.0 * u - 1.0) * bound
    if leaf.init == "normal":
        return torch.randn(leaf.shape, generator=gen, dtype=f32, device=device)
    raise ValueError(f"unknown init kind {leaf.init!r}")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Ordered parameter layout for one model family."""

    leaves: tuple[Leaf, ...]

    def __post_init__(self):
        offsets = {}
        off = 0
        for leaf in self.leaves:
            offsets[leaf.name] = off
            off += leaf.size
        object.__setattr__(self, "_offsets", offsets)
        object.__setattr__(self, "_num_params", off)

    @property
    def num_params(self) -> int:
        return self._num_params

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.leaves)

    def offset(self, name: str) -> int:
        return self._offsets[name]

    # ---- init --------------------------------------------------------------

    def init_theta(self, generator: torch.Generator, device=None
                   ) -> torch.Tensor:
        """Random init following the reference's rules; returns flat f32 on
        the generator's device. The stream is torch's, not JAX's, so tests
        that compare the packages share one theta instead."""
        device = generator.device if device is None else device
        return torch.cat([_init_leaf(l, generator, device).reshape(-1)
                          for l in self.leaves])

    # ---- flat <-> shaped ----------------------------------------------------

    def unravel(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views of ``theta`` (no copy), one per leaf. One ``split``, whose
        backward joins the leaves' gradients in one ``cat`` (a slice per
        leaf would scatter each into a zero vector of theta's size)."""
        pieces = theta.split([l.size for l in self.leaves])
        return {l.name: t.view(l.shape) for l, t in zip(self.leaves, pieces)}

    def ravel(self, params: dict) -> torch.Tensor:
        return torch.cat([params[l.name].reshape(-1) for l in self.leaves])

    # ---- .pth interop (the reference checkpoint is a pickled state_dict,
    # src/algorithm/nets.py:153-161) --------------------------------------------

    def from_state_dict(self, state_dict) -> torch.Tensor:
        parts = []
        for leaf in self.leaves:
            if leaf.name not in state_dict:
                raise KeyError(
                    f"state_dict missing {leaf.name!r}; has {list(state_dict)}")
            t = torch.as_tensor(state_dict[leaf.name]).detach().cpu()
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{leaf.name}: shape {tuple(t.shape)} != expected "
                    f"{leaf.shape}")
            parts.append(t.to(torch.float32).reshape(-1))
        return torch.cat(parts)

    def to_state_dict(self, theta: torch.Tensor) -> dict:
        theta = torch.as_tensor(theta).detach().to("cpu", torch.float32)
        if tuple(theta.shape) != (self.num_params,):
            raise ValueError(
                f"theta shape {tuple(theta.shape)} != ({self.num_params},)")
        return {k: v.clone() for k, v in self.unravel(theta).items()}

    def load_pth(self, path: str) -> torch.Tensor:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return self.from_state_dict(sd)

    def save_pth(self, theta, path: str) -> str:
        torch.save(self.to_state_dict(theta), path)
        return path


def managed_linear(name: str, out_f: int, in_f: int) -> list[Leaf]:
    """Linear layer leaves under the reference's managed-init rule."""
    if reference_init_kind(name + ".weight"):
        return [Leaf(name + ".weight", (out_f, in_f), "xavier_normal"),
                Leaf(name + ".bias", (out_f,), "zeros")]
    return [Leaf(name + ".weight", (out_f, in_f), "kaiming_uniform"),
            Leaf(name + ".bias", (out_f,), "uniform_fan", init_fan=in_f)]


def norm_leaves(name: str, dim: int, affine: bool) -> list[Leaf]:
    """BatchNorm/LayerNorm affine leaves (torch default: weight=1, bias=0)."""
    if not affine:
        return []
    return [Leaf(name + ".weight", (dim,), "ones"),
            Leaf(name + ".bias", (dim,), "zeros")]


def theta_from_numpy(theta, device="cpu") -> torch.Tensor:
    """A flat float32 theta from the JAX package (any array-like in torch
    parameter order) -> the port's flat tensor. Both packages share the leaf
    order, so this is a bitwise copy."""
    arr = np.ascontiguousarray(np.asarray(theta), dtype=np.float32)
    if arr.ndim != 1:
        raise ValueError(f"theta must be flat, got shape {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def theta_to_numpy(theta: torch.Tensor) -> np.ndarray:
    """Inverse of ``theta_from_numpy``: a flat float32 numpy array."""
    return theta.detach().to("cpu", torch.float32).numpy().copy()
