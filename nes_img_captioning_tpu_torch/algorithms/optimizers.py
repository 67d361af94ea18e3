"""NES theta optimizers (port of ``nes_img_captioning_tpu/algorithms/optimizers.py``).

SGD-with-momentum and Adam with the reference's NumPy numerics
(src/algorithm/nic_nes/optimizers.py:38-107), as f32 tensor math on the
theta's device. ``step`` takes the already-negated gradient plus the L2 term
(nic_nes_master.py:133) and returns (state', theta', ratio) with ratio =
||step|| / ||theta||. State files speak the reference's ``optimizer.tar``
format (keys dim/t/stepsize/[momentum|beta1/beta2/epsilon]/[v|m,v], the
vectors as numpy arrays), so they cross-load with the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["OptState", "Optimizer", "SGD", "Adam", "make_optimizer"]


@dataclasses.dataclass
class OptState:
    """Optimizer state on the theta's device. ``m`` unused (zeros) for SGD."""

    t: torch.Tensor  # int32 scalar — step count
    m: torch.Tensor  # (dim,) Adam first moment
    v: torch.Tensor  # (dim,) SGD momentum buffer / Adam second moment


def init_state(dim: int, device=None) -> OptState:
    """Zero state on ``device`` (default: the card)."""
    device = resolve_device(device)
    return OptState(t=torch.zeros((), dtype=torch.int32, device=device),
                    m=torch.zeros((dim,), dtype=torch.float32, device=device),
                    v=torch.zeros((dim,), dtype=torch.float32, device=device))


class Optimizer:
    """Stateless math + host-side hyperparameters (the stepsize is host-side
    because annealing divides it between generations)."""

    kind = ""

    def __init__(self, stepsize: float):
        self.stepsize = float(stepsize)

    def init(self, dim: int, device=None) -> OptState:
        return init_state(dim, device)

    def step(self, state: OptState, theta, globalg, stepsize):
        raise NotImplementedError

    # ---- reference .tar interop ---------------------------------------------

    def state_to_dict(self, state: OptState, dim: int) -> dict:
        raise NotImplementedError

    def state_from_dict(self, d: dict, device=None) -> OptState:
        raise NotImplementedError

    def save_to_file(self, state: OptState, dim: int, path: str):
        torch.save(self.state_to_dict(state, dim), path)

    def load_from_file(self, path: str, device=None) -> OptState:
        d = torch.load(path, map_location="cpu", weights_only=False)
        return self.state_from_dict(d, device)


def _loaded(t, m, v, device) -> OptState:
    """OptState from a state file's step count and vectors (``m`` None for
    SGD), on ``device`` (default: the card)."""
    device = resolve_device(device)
    v = torch.as_tensor(np.asarray(v, np.float32), device=device)
    m = torch.zeros_like(v) if m is None else torch.as_tensor(
        np.asarray(m, np.float32), device=device)
    return OptState(t=torch.tensor(int(t), dtype=torch.int32, device=device),
                    m=m, v=v)


class SGD(Optimizer):
    kind = "sgd"

    def __init__(self, stepsize: float, momentum: float = 0.9):
        super().__init__(stepsize)
        self.momentum = float(momentum)

    def step(self, state, theta, globalg, stepsize):
        v = self.momentum * state.v + (1.0 - self.momentum) * globalg
        step = -stepsize * v
        ratio = torch.linalg.vector_norm(step) / torch.linalg.vector_norm(theta)
        return OptState(t=state.t + 1, m=state.m, v=v), theta + step, ratio

    def state_to_dict(self, state, dim):
        return {"dim": dim, "t": int(state.t), "momentum": self.momentum,
                "stepsize": self.stepsize, "v": state.v.cpu().numpy()}

    def state_from_dict(self, d, device=None):
        self.stepsize = float(d["stepsize"])
        self.momentum = float(d["momentum"])
        return _loaded(d["t"], None, d["v"], device)


class Adam(Optimizer):
    kind = "adam"

    def __init__(self, stepsize: float, beta1=0.9, beta2=0.999,
                 epsilon=1e-08):
        super().__init__(stepsize)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)

    def step(self, state, theta, globalg, stepsize):
        t = state.t + 1
        tf = t.to(torch.float32)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                                     device=theta.device)
        a = (f32(stepsize) * torch.sqrt(1 - torch.pow(f32(self.beta2), tf))
             / (1 - torch.pow(f32(self.beta1), tf)))
        m = self.beta1 * state.m + (1 - self.beta1) * globalg
        v = self.beta2 * state.v + (1 - self.beta2) * (globalg * globalg)
        step = -a * m / (torch.sqrt(v) + self.epsilon)
        ratio = torch.linalg.vector_norm(step) / torch.linalg.vector_norm(theta)
        return OptState(t=t, m=m, v=v), theta + step, ratio

    def state_to_dict(self, state, dim):
        return {"dim": dim, "t": int(state.t), "stepsize": self.stepsize,
                "beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "m": state.m.cpu().numpy(),
                "v": state.v.cpu().numpy()}

    def state_from_dict(self, d, device=None):
        self.stepsize = float(d["stepsize"])
        self.beta1, self.beta2 = float(d["beta1"]), float(d["beta2"])
        self.epsilon = float(d["epsilon"])
        return _loaded(d["t"], d["m"], d["v"], device)


def make_optimizer(optimizer_options: dict) -> Optimizer:
    """From the experiment JSON's ``optimizer_options``
    (reference: src/algorithm/nic_nes/experiment.py:20-23)."""
    kind = optimizer_options["type"]
    args = optimizer_options.get("args", {})
    return {"sgd": SGD, "adam": Adam}[kind](**args)
