"""Per-token reward-weighting fitness criteria (port of ``nes_img_captioning_tpu/fitness/criteria.py``).

The reference's five criteria (src/captioning/fitness.py). Each maps
(logprobs (R, T), seq (R, T), rewards (R, T) or (R, 1)) to ONE scalar for
the whole rollout batch. The mask counts position 0 always and position t
while seq[t-1] > 0 (fitness.py:35-37), i.e. through the first emitted EOS.

One formula source serves two forms: the host form (``apply_criterion``,
numpy f64) and the device form (``criterion_device``, torch f32, on the
tensors' device). The device form also takes leading member axes, (N, R,
T) -> (N,), one scalar per member.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FITNESS_CRITERIA", "apply_criterion", "criterion_device"]

_LOG10_9 = np.log10(9.0)
_E = np.e


def _term(xp, name: str, lp, reward):
    """The per-token weighted term of each criterion, over numpy (the host
    f64 form) or torch (the device f32 form). ``reward`` broadcasts against
    ``lp``. Formulas cite src/captioning/fitness.py."""
    if name == "sc_loss":
        # reward * -logprob (documented harmful, fitness.py:12-40)
        return -lp * reward
    p = xp.exp(lp)
    if name == "greedy_logprob":
        # reward * (log10(p + 1/9) + log10 9): 0 at p=0, reward at p=1
        # (fitness.py:43-64)
        return (xp.log10(p + 1.0 / 9.0) + _LOG10_9) * reward
    if name == "greedy_avgprob":
        # mean of CIDEr reward and the alt-log term (fitness.py:67-86)
        pfact = xp.log10(p + 1.0 / 9.0) + _LOG10_9
        return 0.5 * reward + 0.5 * pfact * reward
    if name == "greedy_expprob":
        # reward * (e^p - 1)/(e - 1) (code of fitness.py:90-109)
        return (xp.exp(p) - 1.0) / (_E - 1.0) * reward
    if name == "greedy_linprob":
        # reward * p (fitness.py:112-132)
        return p * reward
    raise KeyError(name)


def _mask(seq: np.ndarray) -> np.ndarray:
    m = (seq > 0).astype(np.float64)
    return np.concatenate([np.ones((m.shape[0], 1)), m[:, :-1]], axis=1)


def _host(name: str):
    def criterion(lp, seq, reward):
        m = _mask(seq)
        return float((_term(np, name, lp, reward) * m).sum() / m.sum())

    criterion.__name__ = f"{name}_criterion"
    return criterion


# keyed by the Fitness enum values that need a criterion
# (reference: src/captioning/policies.py:50-61)
FITNESS_CRITERIA = {
    name: _host(name)
    for name in ("sc_loss", "greedy_logprob", "greedy_expprob",
                 "greedy_avgprob", "greedy_linprob")
}


def apply_criterion(fitness_name: str, lp, seq, reward) -> float:
    """Host form: one rollout batch, in numpy f64."""
    return FITNESS_CRITERIA[fitness_name](
        np.asarray(lp, np.float64), np.asarray(seq),
        np.asarray(reward, np.float64))


def criterion_device(fitness_name: str, lp: torch.Tensor, seq: torch.Tensor,
                     reward: torch.Tensor) -> torch.Tensor:
    """Device form: the same formulas and mask, reduced in f32 over the last
    two axes (rows, tokens): (..., R, T) -> (...)."""
    lp = lp.to(torch.float32)
    m = torch.cat([torch.ones_like(lp[..., :1]),
                   (seq[..., :-1] > 0).to(torch.float32)], dim=-1)
    term = _term(torch, fitness_name, lp, reward)
    return (term * m).sum((-2, -1)) / m.sum((-2, -1))
