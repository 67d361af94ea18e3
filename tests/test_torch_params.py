"""Port parity: ParamSpec, the eager FC model and .pth interop against the
JAX package (nes_img_captioning_tpu_torch vs nes_img_captioning_tpu)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.models.fc_caption import (
    FCCaptionModel as JaxFCModel,
    FCModelOptions as JaxOptions,
)
from nes_img_captioning_tpu_torch.models.fc_caption import (
    FCCaptionModel,
    FCModelOptions,
    build_spec,
)
from nes_img_captioning_tpu_torch.models.params import (
    theta_from_numpy,
    theta_to_numpy,
)

from torch_pin import one_intra_op_thread  # noqa: F401

FULL = dict(vocab_size=9487, input_encoding_size=128, rnn_size=128,
            fc_feat_size=2048)
TOY = dict(vocab_size=50, input_encoding_size=16, rnn_size=16,
           fc_feat_size=32)


@pytest.mark.parametrize("dims", [FULL, TOY], ids=["full", "toy"])
def test_spec_matches_jax(dims):
    """Leaf names, shapes, offsets and num_params (2,865,808 at full
    width) are the JAX package's; exact."""
    js = JaxFCModel(JaxOptions(**dims)).spec
    ts = build_spec(FCModelOptions(**dims))
    assert ts.names == js.names
    assert [l.shape for l in ts.leaves] == [l.shape for l in js.leaves]
    assert [l.init for l in ts.leaves] == [l.init for l in js.leaves]
    assert [ts.offset(n) for n in ts.names] == [js.offset(n) for n in js.names]
    assert ts.num_params == js.num_params
    if dims is FULL:
        assert ts.num_params == 2_865_808


def test_module_state_dict_order_is_the_spec():
    """The nn.Module's state_dict keys, order and shapes are the spec's, so
    its .pth is the reference format."""
    opts = FCModelOptions(**TOY)
    m = FCCaptionModel(opts, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    sd = m.state_dict()
    assert list(sd) == list(m.spec.names)
    assert [tuple(v.shape) for v in sd.values()] == \
        [l.shape for l in m.spec.leaves]
    theta = m.spec.init_theta(torch.Generator().manual_seed(3))
    m.load_theta(theta)
    assert torch.equal(m.theta(), theta)


def test_init_follows_reference_rules():
    """Managed weights xavier-normal, managed biases zero (the init streams
    differ from JAX's; the rules do not)."""
    spec = build_spec(FCModelOptions(**FULL))
    theta = spec.init_theta(torch.Generator().manual_seed(0))
    p = spec.unravel(theta)
    assert torch.count_nonzero(p["logit.bias"]) == 0
    assert torch.count_nonzero(p["core.i2h.bias"]) == 0
    w = p["logit.weight"]
    expect = np.sqrt(2.0 / (128 + 9488))
    assert abs(float(w.std()) - expect) / expect < 0.01


def test_pth_cross_loads_bit_exact(tmp_path):
    """A .pth written by either package loads bit-exact in the other."""
    js = JaxFCModel(JaxOptions(**TOY)).spec
    ts = build_spec(FCModelOptions(**TOY))
    theta_np = np.asarray(js.init_theta(jax.random.PRNGKey(4)))

    js.save_pth(theta_np, str(tmp_path / "jax.pth"))
    np.testing.assert_array_equal(
        theta_to_numpy(ts.load_pth(str(tmp_path / "jax.pth"))), theta_np)

    ts.save_pth(theta_from_numpy(theta_np), str(tmp_path / "torch.pth"))
    np.testing.assert_array_equal(js.load_pth(str(tmp_path / "torch.pth")),
                                  theta_np)


def test_theta_numpy_round_trip():
    theta_np = np.random.default_rng(0).normal(size=100).astype(np.float32)
    t = theta_from_numpy(theta_np)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(theta_to_numpy(t), theta_np)
    with pytest.raises(ValueError, match="flat"):
        theta_from_numpy(theta_np.reshape(10, 10))


def test_norm_variants_not_ported_yet():
    """The vbn and layer_n variants, once refused, now build with their
    norm leaves in the spec (tests/test_torch_norm_variants.py holds them
    to the JAX package)."""
    for flags, leaf in (({"vbn": True, "vbn_affine": True},
                         "core.c_bn.weight"),
                        ({"layer_n": True, "layer_n_affine": True},
                         "core.c_ln.bias")):
        m = FCCaptionModel(FCModelOptions(**TOY, **flags), device="meta")
        assert leaf in m.spec.names
        assert [n for n, _ in m.named_parameters()] == list(m.spec.names)


@pytest.mark.parametrize("eos_boost", [0.0, 8.0], ids=["plain", "early_stop"])
@pytest.mark.parametrize("dims", [
    dict(vocab_size=50, fc_feat_size=32, input_encoding_size=16, rnn_size=16),
    dict(vocab_size=40, fc_feat_size=16, input_encoding_size=8, rnn_size=8),
], ids=["v50", "v40"])
def test_eager_sample_matches_jax(dims, eos_boost):
    """Greedy ``sample`` against JAX FCCaptionModel.sample at f32: tokens
    equal, logprobs within 2e-5 (the bar tests/test_decode_pallas.py holds
    Pallas to). ``eos_boost`` raises token 0's bias so rows finish early and
    the batch-wide stop is exercised."""
    jm = JaxFCModel(JaxOptions(**dims))
    theta = np.asarray(jm.spec.init_theta(jax.random.PRNGKey(5))).copy()
    theta[jm.spec.offset("logit.bias")] += eos_boost
    feats = np.random.default_rng(2).normal(
        size=(6, dims["fc_feat_size"])).astype(np.float32)
    seq_j, lp_j = jm.sample(jnp.asarray(theta), jnp.asarray(feats),
                            greedy=True)

    tm = FCCaptionModel(FCModelOptions(**dims), theta=theta_from_numpy(theta),
                        device="cpu")
    seq_t, lp_t = tm.sample(torch.from_numpy(feats))
    assert seq_t.dtype == torch.int32
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=2e-5)
    if eos_boost:
        assert (seq_t.numpy()[:, 1:] == 0).all()
