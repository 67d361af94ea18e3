"""Port parity: the per-token fitness criteria (fitness/criteria.py) against
the JAX package's, host form (numpy f64) and device form (f32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nes_img_captioning_tpu.fitness import criteria as jcrit
from nes_img_captioning_tpu_torch.fitness import criteria as tcrit

KINDS = ("sc_loss", "greedy_logprob", "greedy_expprob", "greedy_avgprob",
         "greedy_linprob")


def _rollouts(seed, lead=()):
    """Logprobs, tokens with EOS at random places (rows that end early,
    rows that never end) and one reward per row, signed as self-critical
    rewards are."""
    rng = np.random.default_rng(seed)
    R, T = 10, 16
    lp = -rng.exponential(2.0, size=(*lead, R, T)).astype(np.float32)
    seq = rng.integers(1, 40, size=(*lead, R, T)).astype(np.int32)
    ends = rng.integers(0, T + 4, size=(*lead, R))
    seq[np.arange(T) >= ends[..., None]] = 0
    reward = rng.normal(size=(*lead, R, 1)).astype(np.float32)
    return lp, seq, reward


@pytest.mark.parametrize("kind", KINDS)
def test_criterion_matches_jax(kind):
    """Device form within 1e-6 of JAX criterion_device; host form equal to
    JAX apply_criterion within 1e-12 (both f64), and the device form within
    1e-5 of it."""
    lp, seq, reward = _rollouts(3)
    got = tcrit.criterion_device(kind, torch.from_numpy(lp),
                                 torch.from_numpy(seq),
                                 torch.from_numpy(reward))
    want = jcrit.criterion_device(kind, jnp.asarray(lp), jnp.asarray(seq),
                                  jnp.asarray(reward))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    host = tcrit.apply_criterion(kind, lp, seq, np.repeat(reward, 16, 1))
    np.testing.assert_allclose(
        host, jcrit.apply_criterion(kind, lp, seq, np.repeat(reward, 16, 1)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(got), host, atol=1e-5)
    assert set(tcrit.FITNESS_CRITERIA) == set(jcrit.FITNESS_CRITERIA)


def test_device_form_takes_members():
    """(N, R, T) gives one criterion per member, each the member's own."""
    lp, seq, reward = _rollouts(4, lead=(3,))
    got = tcrit.criterion_device("greedy_linprob", torch.from_numpy(lp),
                                 torch.from_numpy(seq),
                                 torch.from_numpy(reward))
    assert got.shape == (3,)
    for n in range(3):
        one = tcrit.criterion_device(
            "greedy_linprob", torch.from_numpy(lp[n]),
            torch.from_numpy(seq[n]), torch.from_numpy(reward[n]))
        np.testing.assert_allclose(float(got[n]), float(one), atol=1e-7)
    with pytest.raises(KeyError):
        tcrit.criterion_device("greedy", torch.from_numpy(lp),
                               torch.from_numpy(seq), torch.from_numpy(reward))


def test_mask_runs_through_the_first_eos():
    """Position 0 always counts; position t counts while token t-1 > 0."""
    lp = np.log(np.array([[0.5, 0.5, 0.9, 0.9]], np.float32))
    seq = np.array([[5, 0, 0, 0]], np.int32)  # counts positions 0 and 1
    got = tcrit.criterion_device("greedy_linprob", torch.from_numpy(lp),
                                 torch.from_numpy(seq), torch.ones(1, 1))
    assert float(got) == pytest.approx(0.5)
    rew = np.array([[1.0, 1.0, 100.0, 100.0]])
    assert tcrit.apply_criterion("greedy_linprob", lp, seq, rew) == \
        pytest.approx(0.5)
