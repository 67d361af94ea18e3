"""MNIST classification task (port of ``MnistTask`` in ``nes_img_captioning_tpu/tasks/classification.py``).

Fitness is -cross-entropy on the batch, validation top-1 accuracy
(reference: src/classification/policies.py). Both score on the device, so
the engines run their torch-order paths: NIC-NES perturbs the flat theta
(``NESEngine``'s generation without a decode layout), NIC-ES sweeps its
children as they are built.

A rollout evaluates its members in groups of ``MEMBER_GROUP``, the last
group padded by repeating its last member, so every call of the model has
the same shapes whatever the chunk: a member's logits do not depend on how
many members are evaluated with it. The products run with TF32 off and
cuDNN's deterministic algorithms (``numerics``), a property of the task and
not of the process, so the f32 results hold wherever the task is called
from; the sensitivity sweeps enter the same context around their pullbacks.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .base import Task
from ..data.mnist import load_mnist
from ..models.mnist import MnistModel, MnistModelOptions
from ..utils.device import resolve_device

__all__ = ["MEMBER_GROUP", "MnistTask"]

# members per call of the model: experiments/mnist_nes.json's 50 pairs are
# 100 members, mnist_es.json's sweep 50 children, both whole groups
MEMBER_GROUP = 25


class MnistTask(Task):
    artifact_is_fitness = True
    samples = False

    def __init__(self, exp: dict, config, tpu_cfg, device=None,
                 data: dict | None = None):
        """``data``: the arrays of ``load_mnist`` (train_x, train_y, val_x,
        val_y, test_x, test_y) instead of reading them; otherwise the idx
        files under ``exp["data_root"]`` (default ./data), or the synthetic
        set at ``exp["synthetic_sizes"]`` (train, test) when they are
        absent. ``device`` defaults to the card."""
        self.device = resolve_device(device)
        popts = exp.get("policy_options", {})
        self.vbn = bool(popts.get("vbn", False))
        self.model = MnistModel(MnistModelOptions(vbn=self.vbn),
                                device="meta")
        self.config = config
        if data is None:
            data = load_mnist(
                exp.get("data_root", "./data"),
                synthetic_sizes=tuple(exp.get("synthetic_sizes",
                                              (2048, 512))),
                seed=tpu_cfg.seed or 0)

        def place(key, dtype):
            return torch.as_tensor(np.ascontiguousarray(data[key]),
                                   dtype=dtype, device=self.device)

        self.train_x = place("train_x", torch.float32)
        self.train_y = place("train_y", torch.int64)
        self.val_x = place("val_x", torch.float32)
        self.val_y = place("val_y", torch.int64)
        self.test_x = place("test_x", torch.float32)
        self.test_y = place("test_y", torch.int64)
        self._val_dev_cache = None

    @property
    def train_n(self) -> int:
        return self.train_y.shape[0]

    def device_consts(self) -> dict:
        return {"train_x": self.train_x, "train_y": self.train_y}

    def generate_theta(self, generator: torch.Generator):
        return self.spec.init_theta(generator, device=self.device)

    @contextlib.contextmanager
    def numerics(self):
        """f32 products in f32 (TF32 off in cuDNN and cuBLAS) and cuDNN's
        deterministic algorithms, chosen without benchmarking."""
        matmul = torch.backends.cuda.matmul
        prev = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True,
                                            allow_tf32=False):
                yield
        finally:
            matmul.allow_tf32 = prev

    # ---- the model over members ---------------------------------------------

    def logits(self, thetas: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(M, B, 10) logits of M flat thetas, member m on x[m] (x (M, B, 1,
        28, 28)), in groups of MEMBER_GROUP members."""
        M, G = thetas.shape[0], MEMBER_GROUP
        pad = -M % G
        if pad:
            thetas = torch.cat([thetas, thetas[-1:].expand(pad, -1)])
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        with self.numerics():
            out = [self.model.forward_members(thetas[lo:lo + G],
                                              x[lo:lo + G])
                   for lo in range(0, M + pad, G)]
        return torch.cat(out)[:M]

    # ---- fitness -----------------------------------------------------------------

    def rollout(self, thetas, idx, consts=None, lanes=None) -> dict:
        """-CrossEntropyLoss of each member on its batch (reference:
        src/classification/policies.py:16-45): thetas (M, dim) flat f32;
        idx (B,) rows of the training set shared by every member (NIC-ES)
        or (M, B), each member's own (NIC-NES pairs). ``lanes`` is unused
        (no sampling). Returns ``{"fitness": (M,)}``. The reference's VBN
        pre-pass over a reference batch changes nothing with
        track_running_stats=False, so there is none."""
        consts = self.device_consts() if consts is None else consts
        idx = torch.as_tensor(idx, device=self.device).long()
        x, y = consts["train_x"][idx], consts["train_y"][idx]
        if idx.dim() == 1:
            M = thetas.shape[0]
            x, y = x.expand(M, *x.shape), y.expand(M, -1)
        logp = torch.log_softmax(self.logits(thetas, x), dim=-1)
        return {"fitness": logp.gather(-1, y[..., None])[..., 0].mean(-1)}

    # ---- validation --------------------------------------------------------------

    def _val_batches(self, xs, ys, bs: int) -> dict:
        """Equal full batches of a split, like the reference's loop over val
        batches (src/classification/policies.py:47-79): at most
        ``num_val_batches``, at least one."""
        n_batches = xs.shape[0] // bs
        if self.config.num_val_batches:
            n_batches = min(n_batches, self.config.num_val_batches)
        n_batches = max(n_batches, 1)
        use = min(n_batches * bs, xs.shape[0])
        return {"xb": xs[:use].reshape(-1, bs, *xs.shape[1:])[:n_batches],
                "yb": ys[:use].reshape(-1, bs)[:n_batches]}

    def _batch_size(self, n: int) -> int:
        bs = self.config.val_batch_size or self.config.batch_size or 64
        return min(bs, n)

    def device_val_consts(self) -> dict:
        """The val split in validation batches, built once."""
        if self._val_dev_cache is None:
            self._val_dev_cache = self._val_batches(
                self.val_x, self.val_y, self._batch_size(self.val_y.shape[0]))
        return self._val_dev_cache

    def validate_device(self, theta, vconsts) -> torch.Tensor:
        """The mean of the per-batch top-1 accuracies of theta as a 0-d f32
        tensor on the device, with no host sync; the batches are evaluated
        as members of one rollout sharing theta."""
        xb, yb = vconsts["xb"], vconsts["yb"]
        logits = self.logits(theta[None].expand(xb.shape[0], -1), xb)
        return (logits.argmax(-1) == yb).to(torch.float32).mean(-1).mean()

    def validate(self, theta) -> float:
        return float(self.validate_device(theta, self.device_val_consts()))

    def test_score(self, theta) -> float:
        return float(self.validate_device(theta, self._val_batches(
            self.test_x, self.test_y, self._batch_size(self.test_y.shape[0]))))

    # ---- sensitivity -------------------------------------------------------------

    @property
    def sensitivity_groups(self) -> int:
        """K, the columns of ``sensitivity_forward``'s output: the logits."""
        return 10

    def sensitivity_forward(self, theta, idx, consts=None):
        """Raw logits (B, 10) of the flat theta on the train images ``idx``,
        the SM-G output for MNIST (reference: src/classification/nets.py:
        39-48)."""
        x = self.train_x if consts is None else consts["train_x"]
        return self.model.forward_for_sensitivity(theta, x[idx])
