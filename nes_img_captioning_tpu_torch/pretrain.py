"""Teacher-forced cross-entropy (XENT) pretrainer for the FC captioner (port
of ``nes_img_captioning_tpu/pretrain.py``).

The reference's evolution runs warm-start from a backprop-pretrained
checkpoint (``"from_single": "pretrained/bu_xent_09.pth"`` in
experiments/mscoco_*.json; reference README.md:98-106). This module makes
such a checkpoint: Adam with teacher forcing, on the flat theta through
``spec.unravel`` so that autograd gives the gradient, saved as a
reference-format ``.pth`` that ``from_single`` (and the JAX package) read.

Training objective (standard NIC XENT): feed the image embedding at t=0,
<bos>=0 at t=1, then gold tokens; per-step softmax cross-entropy on the gold
caption, masked to caption length + one EOS step.

Usage:
    python -m nes_img_captioning_tpu_torch.pretrain \\
        --exp_file experiments/mscoco_nes.json --steps 3000 --lr 5e-4 \\
        --out pretrained/xent.pth          # --device cpu for the CPU
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .data.core import EpochSampler
from .utils.logger import setup_logging

logger = logging.getLogger(__name__)

__all__ = ["xent_loss", "pretrain_xent"]


def xent_loss(model, theta, fc_feats, captions):
    """Mean masked token cross-entropy of the flat theta, differentiable in
    theta (JAX: pretrain.py:38-77).

    captions: (B, T) gold tokens, 0-padded. Targets are caption tokens then
    one EOS (0); inputs are <bos>, then gold tokens (teacher forcing)."""
    p = model.spec.unravel(theta)
    B, T = captions.shape
    captions = captions.long()
    h = c = theta.new_zeros((B, model.options.rnn_size))
    _, h, c = model.lstm_core(p, model._img_embed(p, fc_feats), h, c)
    inputs = torch.cat([captions.new_zeros((B, 1)), captions[:, :-1]], 1)
    # mask: token positions + the first EOS position
    tok_mask = (captions > 0).to(theta.dtype)
    eos_mask = torch.cat([tok_mask.new_ones((B, 1)), tok_mask[:, :-1]], 1)
    mask = torch.maximum(tok_mask, eos_mask)
    outs = []
    for t in range(T):
        out, h, c = model.lstm_core(p, model._embed(p, inputs[:, t]), h, c)
        outs.append(out)
    # the logits of all steps in one product: rows are independent
    logp = model._logprobs(p, torch.stack(outs, 1))          # (B, T, V + 1)
    nll = -logp.gather(-1, captions[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def pretrain_xent(task, steps: int = 1000, lr: float = 5e-4,
                  batch_size: int = 64, seed: int = 0, log_every: int = 100,
                  theta0: torch.Tensor | None = None) -> torch.Tensor:
    """Backprop-train the task's captioning model on the first caption row
    of each train image; returns the final flat theta on the task's device.
    Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) over
    ``EpochSampler(task.train_n, seed)`` batches, the JAX package's stream.
    ``theta0``: the start (default ``task.generate_theta`` from ``seed``,
    the port's own init stream)."""
    model, dev = task.model, task.device
    caps = torch.as_tensor(np.stack([np.asarray(g[0], np.int32)
                                     for g in task.train_gts]), device=dev)
    feats = task.train_fc
    if theta0 is None:
        theta0 = task.generate_theta(
            torch.Generator(device=dev).manual_seed(seed))
    theta = theta0.detach().to(dev, torch.float32).clone().requires_grad_()
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sampler = EpochSampler(task.train_n, seed=seed)
    for i in range(steps):
        idx = torch.as_tensor(sampler.batch(batch_size), device=dev)
        opt.zero_grad(set_to_none=True)
        loss = xent_loss(model, theta, feats[idx], caps[idx])
        loss.backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            logger.info("xent step %d: loss %.4f", i + 1, loss.item())
    return theta.detach()


def run(argv=None, data=None):
    """The CLI. ``data``: an in-memory CocoData for the task instead of the
    files the experiment names."""
    from .tasks import make_task
    from .utils.config import load_experiment, parse_config, parse_tpu_config

    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_file", type=str,
                        default="experiments/mscoco_nes.json")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="pretrained/xent.pth")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    setup_logging()
    exp = load_experiment(args.exp_file)
    task = make_task(exp, parse_config(exp), parse_tpu_config(exp),
                     device=args.device, data=data)
    theta = pretrain_xent(task, steps=args.steps, lr=args.lr,
                          batch_size=args.batch_size, seed=args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    task.spec.save_pth(theta, args.out)
    score = task.validate(theta)
    logger.info("saved %s (val CIDEr %.4f)", args.out, score)
    return args.out


if __name__ == "__main__":
    run()
