"""Port parity for NIC-NES with the sensitivity-scaled safe mutations, on
the CPU at toy size (vocab 40, E = R = 16, 24-d features, 4 pairs, batch
4; the sensitivities over the first 3 rows of member 0's batch, in 6 vocab
groups).

One SM-G-SUM (or SM-VECTOR) generation of the port's NESEngine, its noise
scale ``sigma / sens`` computed by the port, against the JAX engine's
generation on JAX's own sensitivity: both draw JAX's N(0, 1) per seed (the
port through its ``delta_of`` seam), JAX decodes with its pair kernel in
interpret mode and steps with ``update(deltas=...)``. That comparison steps
with SGD: Adam's first step is ill-conditioned wherever -grad/2F + l2*theta
nears its epsilon, and under the sensitivity's smaller noise every draw of
seeds and batches tried here has such elements (the smallest |globalg|
between 2e-9 and 2e-6, where tests/test_torch_kernel_noise.py asks for
3e-6), while the SGD step is linear in the gradient. Then the port's own
paths, with Adam: inline sensitivities against the host-computed ones,
blocks against single generations, and the block rule.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_PAIRS, B, SIGMA, STEP, L2, UNDERFLOW = 4, 4, 0.05, 0.01, 1e-7, 0.01
# the JAX comparison's SGD: its first step is -SGD_STEP * 0.1 * globalg,
# theta moved by globalg itself
SGD_STEP = 10.0
TPU = {"seed": 0, "fused_decode": True, "precision": "f32",
       "sensitivity_split": 8, "sensitivity_batch": 3}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The JAX task (fused decode in interpret mode) and the port's on the
    same data, one theta (a JAX init, doubled so that many sensitivities
    clear the underflow), seeds and batches."""
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    d = str(tmp_path_factory.mktemp("coco_nes_smg"))
    copts = make_synthetic_coco(d, n_train=12, n_val=4, n_test=4,
                                vocab_size=40, fc_feat_size=24, cap_len=6,
                                seed=0)
    exp = {"dataset": "mscoco", "caption_options": copts,
           "policy_options": {"fitness": "greedy", "model_options": {
               "input_encoding_size": 16, "rnn_size": 16,
               "fc_feat_size": 24}},
           "tpu": dict(TPU)}
    jtask = JTask(exp, JConfig(batch_size=B), jp(exp))
    jtask._fused_interpret = True
    ttask = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                     device="cpu")
    rng = np.random.default_rng(19)
    return {"copts": copts, "jtask": jtask, "ttask": ttask,
            "seeds": rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32),
            "idx": rng.integers(0, 12, size=(F_PAIRS, B)).astype(np.int32),
            "theta": 2.0 * np.asarray(jtask.generate_theta(
                jax.random.PRNGKey(6)))}


def _jax_engine(toy, kind):
    from nes_img_captioning_tpu.algorithms.nes import NESEngine
    from nes_img_captioning_tpu.algorithms.optimizers import SGD
    from nes_img_captioning_tpu.ops.mutation import MutationKind

    return NESEngine(toy["jtask"], SGD(SGD_STEP), MutationKind(kind),
                     pop_chunk=2, inline_sens=False)


def _port_engine(toy, kind, sgd=False, **kw):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam, SGD
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    opt = SGD(SGD_STEP) if sgd else Adam(STEP)
    return NESEngine(toy["ttask"], opt, MutationKind(kind),
                     pop_chunk=3, kernel_perturb=True, delta_dtype="f32",
                     sens_underflow=UNDERFLOW, sens_batch=3, **kw)


def _generation(toy, eng, sens=None):
    theta = torch.from_numpy(toy["theta"].copy())
    sens = torch.ones_like(theta) if sens is None else sens
    return eng.generation(theta, eng.optimizer.init(eng.dim, "cpu"), sens,
                          SIGMA, toy["seeds"], toy["idx"],
                          eng.optimizer.stepsize, L2)


def _vector(dim):
    return np.random.default_rng(3).uniform(0.0, 0.1, dim).astype(np.float32)


@pytest.mark.parametrize("kind", ["SM-G-SUM", "SM-VECTOR"])
def test_safe_generation_matches_jax(toy, kind):
    """The port's generation (SM-G-SUM: its sensitivity inline from theta
    over member 0's first 3 rows; SM-VECTOR: the normalized vector) against
    the JAX engine's eval_generation and update on JAX's sensitivity, both
    drawing JAX's normals, both stepping with SGD: the noise scales within
    2e-4, the fitnesses within 1e-5, theta (moved by up to 1e-2) within
    1e-6, ratio and mean|theta| within 1e-6 relative."""
    from nes_img_captioning_tpu.ops import sensitivity as jsens
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        sm_vector_normalize,
    )

    jeng, eng = _jax_engine(toy, kind), _port_engine(toy, kind, sgd=True)
    assert eng.inline_sens == (kind == "SM-G-SUM")
    jtask, lay = toy["jtask"], toy["ttask"].decode_layout
    theta = jnp.asarray(toy["theta"])
    if kind == "SM-G-SUM":
        jsens_v = jsens.calc_sensitivity(
            jtask, theta, jnp.asarray(toy["idx"][0][:3]),
            JKind.SAFE_GRAD_SUM, UNDERFLOW)
        sens = None
    else:
        vec = sm_vector_normalize(_vector(eng.dim), UNDERFLOW)
        jsens_v, sens = jnp.asarray(vec), torch.from_numpy(vec.copy())
    art, jdeltas = jeng.eval_generation(theta, jsens_v, SIGMA, toy["seeds"],
                                        toy["idx"])
    jfits = np.asarray(jtask.host_fitness(art, toy["idx"]))
    jdeltas = np.asarray(jdeltas).reshape(-1, eng.dim)[:F_PAIRS]

    # the JAX engine's unfused sweep draws N(0, 1) in torch order
    normals = {int(s): lay.to_dec(torch.from_numpy(np.asarray(
        jax.random.normal(jeng._mk_key(jnp.uint32(s)), (eng.dim,),
                          jnp.float32)).copy()), pad_scale=0.0)
               for s in toy["seeds"]}
    scales = []

    def delta_of(scale_dec, seed):
        scales.append(scale_dec)
        return scale_dec * normals[int(seed)]

    eng.delta_of = delta_of
    th, _, packed = _generation(toy, eng, sens)
    fits, ratio, norm = eng.unpack(packed, F_PAIRS)

    want_scale = np.asarray(jeng._scale_vec(theta, jsens_v, SIGMA))
    got_scale = lay.from_dec(scales[0]).numpy()
    np.testing.assert_allclose(got_scale, want_scale, rtol=2e-4, atol=0)
    assert np.ptp(want_scale) > 0  # not a uniform scale
    np.testing.assert_allclose(fits, jfits, rtol=0, atol=1e-5)
    assert np.ptp(fits) > 0
    _, theta_new, jratio = jeng.update(
        theta, jeng.optimizer.init(jeng.dim), jsens_v, SIGMA, toy["seeds"],
        jnp.asarray(jfits), SGD_STEP, L2, deltas=jnp.asarray(jdeltas[None]))
    moved = np.abs(np.asarray(theta_new) - toy["theta"]).max()
    assert 1e-3 < moved < 0.1
    np.testing.assert_allclose(th.numpy(), np.asarray(theta_new), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ratio, float(jratio), rtol=1e-6)
    np.testing.assert_allclose(norm, float(jnp.abs(theta_new).mean()),
                               rtol=1e-6)


@pytest.mark.parametrize("kernel_noise", [False, True],
                         ids=["deltas", "kernel_noise"])
def test_inline_and_host_sensitivity_bitwise_equal(toy, kernel_noise):
    """The inline sensitivity (computed in the generation from its theta)
    and the host path's (``sensitivity`` handed in with inline_sens off)
    give the same packed vector and theta bit for bit, on delta operands
    and on kernel noise; inline_sens=True needs an SM-G kind."""
    inline = _port_engine(toy, "SM-G-SUM", kernel_noise=kernel_noise)
    host = _port_engine(toy, "SM-G-SUM", kernel_noise=kernel_noise,
                        inline_sens=False)
    assert inline.inline_sens and not host.inline_sens
    assert host._kernel_noise is kernel_noise
    theta = torch.from_numpy(toy["theta"].copy())
    sens = host.sensitivity(theta, toy["idx"][0], toy["seeds"][0])
    assert (sens > 1).any()
    th_i, _, packed_i = _generation(toy, inline)
    th_h, _, packed_h = _generation(toy, host, sens)
    assert torch.equal(packed_i, packed_h) and torch.equal(th_i, th_h)
    th_1, _, _ = _generation(toy, host)  # sigma alone: another theta
    assert not torch.equal(th_1, th_h)
    with pytest.raises(ValueError, match="inline_sens"):
        _port_engine(toy, "", inline_sens=True)


def _master_exp(copts, log_dir, mutation="SM-G-SUM", **tpu):
    """experiments/mscoco_nes.json cut to toy size (4 pairs, batch 4, 4
    validation images), with a safe mutation at underflow 0.01."""
    with open(os.path.join(REPO, "experiments", "mscoco_nes.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=B, val_batch_size=4, num_val_items=4,
                         snapshot_freq=4)
    exp["policy_options"]["model_options"].update(
        safe_mutations=mutation, safe_mutation_underflow=UNDERFLOW,
        input_encoding_size=16, rnn_size=16, fc_feat_size=24)
    exp.update(nb_offspring=F_PAIRS, caption_options=copts,
               log_dir=str(log_dir))
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, "precision": "f32",
                  "sensitivity_split": 8, "sensitivity_batch": 3, **tpu}
    return exp


def _torch_master(exp, inline=True):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    m = NESMaster(exp, device="cpu")
    m.engine.inline_sens = inline
    blocks = []
    gen_block = m.engine.generation_block
    val_block = m.engine.generation_val_block

    def gb(theta, opt_state, sens, sigma, seeds, *a):
        blocks.append(seeds.shape[0])
        return gen_block(theta, opt_state, sens, sigma, seeds, *a)

    def vb(theta, opt_state, sens, sigma, seeds, *a):
        blocks.append(seeds.shape[0])
        return val_block(theta, opt_state, sens, sigma, seeds, *a)

    m.engine.generation_block, m.engine.generation_val_block = gb, vb
    return m, blocks


@pytest.mark.parametrize("kernel_noise", [False, True],
                         ids=["deltas", "kernel_noise"])
def test_master_blocks_inline_and_host_paths_agree(toy, tmp_path,
                                                   kernel_noise):
    """NESMaster with SM-G-SUM, 4 iterations: blocks of up to 2 with inline
    sensitivities (validated on the card's path; an epoch is 3
    generations), single generations inline, and single generations with
    the master's host-computed sensitivity all end on the same theta, bit
    for bit."""
    thetas = {}
    for name, gpd, inline in (("block", 2, True), ("single", 1, True),
                              ("host", 1, False)):
        exp = _master_exp(toy["copts"], tmp_path / name,
                          gens_per_dispatch=gpd, kernel_noise=kernel_noise)
        m, blocks = _torch_master(exp, inline)
        m.run_master(max_iterations=4)
        assert blocks == ([2, 1, 1] if gpd == 2 else [1] * 4), name
        assert m._val_fused == (gpd == 2)
        thetas[name] = m.theta
    assert torch.equal(thetas["block"], thetas["single"])
    assert torch.equal(thetas["host"], thetas["single"])
    assert np.isfinite(thetas["host"].numpy()).all()


def test_block_refused_to_host_sensitivity_with_warning(toy, tmp_path,
                                                        caplog):
    """With inline_sens off, the sensitivity is fixed per dispatch, so
    gens_per_dispatch 4 runs every SM-G generation alone, with one
    warning."""
    exp = _master_exp(toy["copts"], tmp_path / "host", gens_per_dispatch=4)
    m, blocks = _torch_master(exp, inline=False)
    with caplog.at_level(logging.WARNING):
        m.run_master(max_iterations=4)
    assert blocks == [1, 1, 1, 1]
    warned = [r for r in caplog.records if "host-computed" in r.getMessage()]
    assert len(warned) == 1


def test_master_sm_vector_matches_jax(toy, tmp_path):
    """SM-VECTOR: the port's NESMaster loads the .pt vector of
    ``safe_mutation_vector`` to the JAX master's normalized vector, bit for
    bit, as does ``set_sensitivity_vector``; its engine computes no
    sensitivity."""
    from nes_img_captioning_tpu.algorithms.nes import NESMaster as JMaster

    dim = toy["ttask"].spec.num_params
    path = str(tmp_path / "sens.pt")
    torch.save(torch.from_numpy(_vector(dim)), path)
    exp = _master_exp(toy["copts"], tmp_path / "jax", "SM-VECTOR")
    exp["policy_options"]["model_options"]["safe_mutation_vector"] = path
    jm = JMaster(json.loads(json.dumps(exp)))
    exp["log_dir"] = str(tmp_path / "torch")
    tm, _ = _torch_master(exp, inline=False)
    want = np.asarray(jm._sens)
    np.testing.assert_array_equal(tm._sens.numpy(), want)
    tm.set_sensitivity_vector(_vector(dim), UNDERFLOW)
    np.testing.assert_array_equal(tm._sens.numpy(), want)
    assert tm._maybe_sensitivity(np.arange(B), 0) is tm._sens
