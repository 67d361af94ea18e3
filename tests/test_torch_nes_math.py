"""Port parity: ranks, mutation shaping, optimizers, the engine's chunk plan,
config parsing and the data layer against the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nes_img_captioning_tpu.algorithms import optimizers as jopt
from nes_img_captioning_tpu.ops import mutation as jmut
from nes_img_captioning_tpu.ops import ranks as jranks
from nes_img_captioning_tpu_torch.algorithms import optimizers as topt
from nes_img_captioning_tpu_torch.ops import mutation as tmut
from nes_img_captioning_tpu_torch.ops import ranks as tranks

from torch_pin import one_intra_op_thread  # noqa: F401


def test_centered_ranks_with_ties_match_jax():
    """Stable-sort tie rule: tied fitnesses rank in position order."""
    x = np.array([[3.0, 1.0], [1.0, 1.0], [2.0, 3.0], [0.5, 2.0]], np.float32)
    want = np.asarray(jranks.compute_centered_ranks(jnp.asarray(x)))
    got = tranks.compute_centered_ranks(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tranks.compute_ranks(torch.tensor([1.0, 1.0, 1.0, 0.0])).numpy(),
        [1, 2, 3, 0])
    rnd = np.random.default_rng(0).integers(0, 5, size=64).astype(np.float32)
    np.testing.assert_array_equal(
        tranks.compute_ranks(torch.from_numpy(rnd)).numpy(),
        np.asarray(jranks.compute_ranks(jnp.asarray(rnd))))


@pytest.mark.parametrize("proportional,safe", [(False, False), (True, False),
                                               (False, True)])
def test_shape_noise_matches_jax(proportional, safe):
    rng = np.random.default_rng(1)
    noise = rng.normal(size=50).astype(np.float32)
    theta = rng.normal(size=50).astype(np.float32)
    theta[::7] = 0.0
    sens = (rng.random(50) + 0.5).astype(np.float32) if safe else None
    want = np.asarray(jmut.shape_noise(
        jnp.asarray(noise), jnp.asarray(theta),
        None if sens is None else jnp.asarray(sens), proportional))
    got = tmut.shape_noise(
        torch.from_numpy(noise), torch.from_numpy(theta),
        None if sens is None else torch.from_numpy(sens), proportional)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert tmut.MutationKind("SM-PROPORTIONAL").is_proportional
    assert tmut.MutationKind("SM-VECTOR").is_safe


def test_noise_is_a_function_of_the_seed():
    a = tmut.normal_from_seed(2**32 - 1, 1000, "cpu")
    assert torch.equal(a, tmut.normal_from_seed(2**32 - 1, 1000, "cpu"))
    assert not torch.equal(a, tmut.normal_from_seed(7, 1000, "cpu"))
    assert abs(float(a.std()) - 1.0) < 0.1


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_steps_match_jax(kind):
    """Three steps from the same state and gradients: theta within 1e-6,
    ratio within 1e-6 relative."""
    rng = np.random.default_rng(2)
    dim = 200
    theta = rng.normal(size=dim).astype(np.float32)
    grads = [rng.normal(size=dim).astype(np.float32) * 10 ** -k
             for k in range(3)]
    jo = jopt.Adam(0.01) if kind == "adam" else jopt.SGD(0.01, 0.9)
    to = topt.Adam(0.01) if kind == "adam" else topt.SGD(0.01, 0.9)
    js, ts = jo.init(dim), to.init(dim, "cpu")
    jth, tth = jnp.asarray(theta), torch.from_numpy(theta)
    for g in grads:
        js, jth, jr = jo.step(js, jth, jnp.asarray(g), jnp.float32(0.01))
        ts, tth, tr = to.step(ts, tth, torch.from_numpy(g), 0.01)
        np.testing.assert_allclose(tth.numpy(), np.asarray(jth), atol=1e-6)
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-6)
    assert int(ts.t) == int(js.t) == 3


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_tar_cross_loads(tmp_path, kind):
    """optimizer.tar written by either package loads in the other."""
    dim = 10
    rng = np.random.default_rng(3)
    m, v = (rng.normal(size=dim).astype(np.float32) for _ in range(2))
    jo = jopt.make_optimizer({"type": kind, "args": {"stepsize": 0.02}})
    to = topt.make_optimizer({"type": kind, "args": {"stepsize": 0.02}})
    js = jopt.OptState(t=jnp.asarray(4, jnp.int32), m=jnp.asarray(m),
                       v=jnp.asarray(v))
    jo.save_to_file(js, dim, str(tmp_path / "jax.tar"))
    ts = to.load_from_file(str(tmp_path / "jax.tar"), device="cpu")
    assert int(ts.t) == 4
    np.testing.assert_array_equal(ts.v.numpy(), v)
    if kind == "adam":
        np.testing.assert_array_equal(ts.m.numpy(), m)
    to.save_to_file(ts, dim, str(tmp_path / "torch.tar"))
    back = jo.load_from_file(str(tmp_path / "torch.tar"))
    assert int(back.t) == 4
    np.testing.assert_array_equal(np.asarray(back.v), v)
    assert to.state_to_dict(ts, dim).keys() == jo.state_to_dict(js, dim).keys()


def test_engine_plan_and_lay_out_match_jax():
    """Chunk plan and pad-lane layout (repeat the last member) of
    PopulationEngine; pad lanes get weight 0."""
    from nes_img_captioning_tpu.algorithms.engine_base import (
        PopulationEngine as JaxEngine,
    )
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JaxNES
    from nes_img_captioning_tpu_torch.algorithms.engine_base import (
        PopulationEngine,
    )
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine

    class _Task:  # the engines read only task.spec.num_params here
        class spec:
            num_params = 3

    for pop_chunk, n in [(0, 7), (3, 7), (24, 144), (10, 4)]:
        je = JaxEngine(_Task(), pop_chunk=pop_chunk)
        te = PopulationEngine(_Task(), pop_chunk=pop_chunk)
        assert te._plan(n) == je._plan(n)
        arr = np.arange(n * 2).reshape(n, 2)
        np.testing.assert_array_equal(te._lay_out(arr, *te._plan(n)),
                                      np.asarray(je._lay_out(arr, *je._plan(n))))
    fits = np.random.default_rng(4).normal(size=(5, 2)).astype(np.float32)
    want = np.asarray(JaxNES._pair_weights(jnp.asarray(fits), (2, 3)))
    got = NESEngine._pair_weights(torch.from_numpy(fits), (2, 3)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1, 2] == 0.0


def test_config_parses_like_jax():
    from nes_img_captioning_tpu.utils import config as jcfg
    from nes_img_captioning_tpu_torch.utils import config as tcfg

    exp = jcfg.load_experiment("experiments/mscoco_nes.json")
    assert dataclasses.asdict(tcfg.parse_tpu_config(exp)) == \
        dataclasses.asdict(jcfg.parse_tpu_config(exp))
    assert dataclasses.asdict(tcfg.parse_config(exp)) == \
        dataclasses.asdict(jcfg.parse_config(exp))
    ok = tcfg.parse_tpu_config({"tpu": {"delta_dtype": "bfloat16",
                                        "kernel_perturb": False}})
    assert ok.delta_dtype == "bf16" and ok.kernel_perturb is False
    for bad in ({"kernel_noise": "false"}, {"fused_decode": 0},
                {"delta_dtype": "int8"}, {"no_such_knob": 1}):
        with pytest.raises(ValueError):
            tcfg.parse_tpu_config({"tpu": bad})


@pytest.mark.parametrize("impl", ["", "threefry2x32", "rbg", "unsafe_rbg",
                                  "rgb"])
def test_rng_impl_takes_jax_names(impl):
    """tpu.rng_impl takes the names jax.random.key(impl=) takes and rejects
    any other with ValueError, as JAX does; mscoco_nes.json's "rbg"
    parses."""
    import jax

    from nes_img_captioning_tpu.utils import config as jcfg
    from nes_img_captioning_tpu_torch.utils import config as tcfg

    exp = {"tpu": {"rng_impl": impl}}
    try:
        jax.random.key(0, impl=impl or None)
    except ValueError:
        with pytest.raises(ValueError, match="rng_impl"):
            tcfg.parse_tpu_config(exp)
        assert impl == "rgb"
    else:
        assert tcfg.parse_tpu_config(exp).rng_impl == impl
    file = jcfg.load_experiment("experiments/mscoco_nes.json")
    assert tcfg.parse_tpu_config(file).rng_impl == "rbg"


def test_master_logs_rng_impl_once(tmp_path, caplog):
    """A set tpu.rng_impl is logged once at master start: the port has no
    counterpart for it."""
    import logging

    from nes_img_captioning_tpu_torch.algorithms.master_base import MasterBase
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    exp = load_experiment("experiments/mnist_nes.json")
    exp.update(log_dir=str(tmp_path), synthetic_sizes=[32, 16])
    exp["tpu"] = {**exp.get("tpu", {}), "rng_impl": "rbg"}
    with caplog.at_level(logging.WARNING):
        MasterBase(exp, device="cpu")
    notes = [r for r in caplog.records if "rng_impl" in r.getMessage()]
    assert len(notes) == 1 and "'rbg'" in notes[0].getMessage()


def test_synthetic_data_matches_jax_fixture(tmp_path):
    """The in-memory fixture draws the JAX fixture's numbers; CocoData from
    memory and from the written files agree with JAX CocoData."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JaxCoco
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data import synthetic as tsyn

    kw = dict(n_train=12, n_val=4, n_test=4, vocab_size=40, fc_feat_size=24,
              cap_len=6, seed=0)
    jd = JaxCoco(make_synthetic_coco(str(tmp_path / "jax"), **kw))
    arrays = tsyn.synthetic_coco_arrays(**kw)
    from_mem = CocoData.from_arrays(arrays)
    from_disk = CocoData(tsyn.write_synthetic_coco(str(tmp_path / "t"),
                                                   arrays))
    for d in (from_mem, from_disk):
        assert (d.vocab_size, d.seq_length) == (jd.vocab_size, jd.seq_length)
        for split in ("train", "val", "test"):
            assert d.split_len(split) == jd.split_len(split)
            np.testing.assert_array_equal(d.split_feats(split),
                                          jd.split_feats(split))
            for a, b in zip(d.split_gts(split), jd.split_gts(split)):
                np.testing.assert_array_equal(a, b)


def test_epoch_sampler_matches_jax():
    from nes_img_captioning_tpu.data.core import EpochSampler as JaxSampler
    from nes_img_captioning_tpu_torch.data.core import EpochSampler

    js, ts = JaxSampler(50, seed=3), EpochSampler(50, seed=3)
    np.testing.assert_array_equal(ts.member_batches(6, 8),
                                  js.member_batches(6, 8))
    np.testing.assert_array_equal(ts.batch(20), js.batch(20))
    restored = EpochSampler.from_state_dict(ts.state_dict())
    np.testing.assert_array_equal(restored.batch(40), ts.batch(40))
