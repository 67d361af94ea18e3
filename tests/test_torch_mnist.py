"""Port parity for MNIST: the port's loader, CNN and ``MnistTask`` against
the JAX package's, on the CPU at toy size (synthetic sizes (256, 128), so 64
validation images; batch 16), f32.

Both packages read the same arrays and the same thetas (JAX inits, handed
to the port as plain arrays). Logits and fitnesses agree within 1e-5 (abs),
accuracies exactly, and the SM-G sensitivities within rtol 2e-4, atol 1e-6,
the bar of ``tests/test_sensitivity_oracle.py``.
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu_torch.ops import sensitivity as tsens
from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

from torch_pin import one_intra_op_thread  # noqa: F401

SIZES, B, ATOL = (256, 128), 16, 1e-5
SENS_RTOL, SENS_ATOL, UNDERFLOW = 2e-4, 1e-6, 0.2
VBN = pytest.mark.parametrize("vbn", [False, True], ids=["plain", "vbn"])


def _exp(vbn, **over):
    return {"dataset": "mnist", "synthetic_sizes": list(SIZES),
            "policy_options": {"net": "mnist", "vbn": vbn},
            "tpu": {"seed": 0}, **over}


@pytest.fixture(scope="module")
def tasks():
    """{vbn: (JAX MnistTask, port MnistTask)} on the same synthetic data."""
    from nes_img_captioning_tpu.tasks.classification import MnistTask as JT
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks import make_task
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    out = {}
    for vbn in (False, True):
        exp = _exp(vbn)
        out[vbn] = (JT(exp, JConfig(batch_size=B), jp(exp)),
                    make_task(exp, Config(batch_size=B),
                              parse_tpu_config(exp), device="cpu"))
    return out


def _thetas(jtask, n, scale=1.0):
    """(n, dim) JAX inits; ``scale`` widens them so that more of the
    sensitivities clear the underflow."""
    return scale * np.stack([np.asarray(jtask.model.spec.init_theta(
        jax.random.PRNGKey(i + 7))) for i in range(n)])


def _batches(m, seed=0):
    return np.random.default_rng(seed).integers(0, SIZES[0], (m, B))


# ---- data ----------------------------------------------------------------------


def _write_idx(path, arr):
    head = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("source", ["synthetic", "idx_files"])
def test_loader_arrays_bitwise_equal_jax(tmp_path, source):
    """``load_mnist`` gives JAX's arrays bit for bit, dtype included: the
    synthetic set at (256, 128), or idx files (gzipped and raw, under
    MNIST/raw) with the seeded val/test halves."""
    from nes_img_captioning_tpu.data.mnist import load_mnist as jload
    from nes_img_captioning_tpu_torch.data.mnist import load_mnist

    root = str(tmp_path)
    if source == "idx_files":
        raw = tmp_path / "MNIST" / "raw"
        raw.mkdir(parents=True)
        rng = np.random.default_rng(4)
        _write_idx(str(raw / "train-images-idx3-ubyte.gz"),
                   rng.integers(0, 256, (40, 28, 28)))
        _write_idx(str(raw / "train-labels-idx1-ubyte"),
                   rng.integers(0, 10, 40))
        _write_idx(str(raw / "t10k-images-idx3-ubyte"),
                   rng.integers(0, 256, (21, 28, 28)))
        _write_idx(str(raw / "t10k-labels-idx1-ubyte.gz"),
                   rng.integers(0, 10, 21))
    want = jload(root, synthetic_sizes=SIZES, seed=3)
    got = load_mnist(root, synthetic_sizes=SIZES, seed=3)
    assert set(got) == set(want)
    n_train = 40 if source == "idx_files" else SIZES[0]
    assert got["train_x"].shape == (n_train, 1, 28, 28)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- model -------------------------------------------------------------------------


@VBN
def test_spec_and_module_match_jax(vbn):
    """Leaf names, shapes, order and init kinds of the JAX spec; 8,490
    parameters (8,550 with vbn); the module's state_dict in that order; a
    port init follows the reference's rules (conv2's bias zero, bn weights
    one, conv1 within its torch-default bound)."""
    from nes_img_captioning_tpu.models.mnist import MnistModel as JModel
    from nes_img_captioning_tpu.models.mnist import MnistModelOptions as JO
    from nes_img_captioning_tpu_torch.models.mnist import (
        MnistModel,
        MnistModelOptions,
    )

    jspec = JModel(JO(vbn=vbn)).spec
    g = torch.Generator().manual_seed(1)
    model = MnistModel(MnistModelOptions(vbn=vbn), generator=g, device="cpu")
    spec = model.spec
    assert [(l.name, l.shape, l.init, l.init_fan) for l in spec.leaves] == \
        [(l.name, tuple(l.shape), l.init, l.init_fan) for l in jspec.leaves]
    assert spec.num_params == jspec.num_params == (8550 if vbn else 8490)
    assert list(model.state_dict()) == list(spec.names)
    p = spec.unravel(model.theta())
    assert torch.equal(p["conv2.bias"], torch.zeros(20))
    assert p["conv1.weight"].abs().max() <= 0.2
    if vbn:
        assert torch.equal(p["bn2.weight"], torch.ones(20))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@VBN
def test_pth_cross_loads(tmp_path, tasks, writer, vbn):
    """A ``.pth`` written by either package's spec loads bit for bit in the
    other's, and into the port's module."""
    from nes_img_captioning_tpu_torch.models.mnist import (
        MnistModel,
        MnistModelOptions,
    )

    jtask, ttask = tasks[vbn]
    theta = _thetas(jtask, 1)[0]
    path = str(tmp_path / "m.pth")
    if writer == "jax":
        jtask.spec.save_pth(jnp.asarray(theta), path)
        got = ttask.spec.load_pth(path).numpy()
    else:
        ttask.spec.save_pth(torch.from_numpy(theta), path)
        got = np.asarray(jtask.spec.load_pth(path))
    np.testing.assert_array_equal(got, theta)
    model = MnistModel(MnistModelOptions(vbn=vbn),
                       theta=ttask.spec.load_pth(path), device="cpu")
    np.testing.assert_array_equal(model.theta().numpy(), theta)


@VBN
def test_logits_match_jax(tasks, vbn):
    """``forward_members`` of 6 members, each on its own 16 images, within
    1e-5 of JAX ``MnistModel.apply`` member by member; the module's own
    forward (one member: another call shape) gives member 0's rows
    within 1e-5."""
    from nes_img_captioning_tpu_torch.models.mnist import (
        MnistModel,
        MnistModelOptions,
    )

    jtask, ttask = tasks[vbn]
    thetas, idx = _thetas(jtask, 6), _batches(6)
    want = np.stack([np.asarray(jtask.model.apply(
        jnp.asarray(thetas[i]), jtask.train["x"][idx[i]])) for i in range(6)])
    th = torch.from_numpy(thetas)
    x = ttask.train_x[torch.from_numpy(idx)]
    got = ttask.model.forward_members(th, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    module = MnistModel(MnistModelOptions(vbn=vbn), theta=th[0],
                        device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(module(x[0]), got[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("batches", ["own", "shared"])
@VBN
def test_rollout_fitness_matches_jax(tasks, vbn, batches):
    """-cross-entropy of 6 members within 1e-5 of JAX ``rollout``: each on
    its own batch (idx (M, B), NIC-NES) or all on one (idx (B,),
    NIC-ES)."""
    jtask, ttask = tasks[vbn]
    thetas, idx = _thetas(jtask, 6), _batches(6, seed=1)
    rows = idx if batches == "own" else np.repeat(idx[:1], 6, 0)
    want = np.array([float(jtask.rollout(jnp.asarray(thetas[i]),
                                         jnp.asarray(rows[i])))
                     for i in range(6)])
    arg = idx if batches == "own" else idx[0]
    got = ttask.rollout(torch.from_numpy(thetas), torch.from_numpy(arg))
    np.testing.assert_allclose(got["fitness"].numpy(), want, rtol=0,
                               atol=ATOL)
    assert np.ptp(want) > 0.01


@pytest.mark.parametrize("bs,num_val_batches", [(16, None), (24, 2)])
@VBN
def test_validation_accuracy_equals_jax(tasks, vbn, bs, num_val_batches):
    """``validate``, ``validate_device`` and ``test_score`` equal JAX's
    accuracies for 3 thetas, over full batches of ``bs`` (at most
    ``num_val_batches``). A mismatch reports the smallest top-2 logit gap
    of the port's rows (a near-tie may pick another class)."""
    import dataclasses

    jtask, ttask = tasks[vbn]
    jcfg, tcfg = jtask.config, ttask.config
    jtask.config = dataclasses.replace(jcfg, val_batch_size=bs,
                                       num_val_batches=num_val_batches)
    ttask.config = dataclasses.replace(tcfg, val_batch_size=bs,
                                       num_val_batches=num_val_batches)
    ttask._val_dev_cache = None
    try:
        for theta in _thetas(jtask, 3, scale=3.0):
            th = torch.from_numpy(theta)
            vc = ttask.device_val_consts()
            dev = ttask.validate_device(th, vc)
            assert dev.dim() == 0 and dev.dtype == torch.float32
            got = (ttask.validate(th), float(dev), ttask.test_score(th))
            want = (jtask.validate(jnp.asarray(theta)),) * 2 + (
                jtask.test_score(jnp.asarray(theta)),)
            logits = ttask.logits(th[None].expand(vc["xb"].shape[0], -1),
                                  vc["xb"])
            top2 = logits.topk(2, -1).values
            gap = float((top2[..., 0] - top2[..., 1]).min())
            assert got == want, f"smallest top-2 gap {gap:.3g}"
        n = 64 // bs if num_val_batches is None else num_val_batches
        assert vc["xb"].shape == (n, bs, 1, 28, 28)
    finally:
        jtask.config, ttask.config = jcfg, tcfg
        ttask._val_dev_cache = None


def test_member_fitness_does_not_depend_on_chunk(tasks):
    """A member's fitness has the same bits in a rollout of 3 members as in
    one of 31 (two groups), at another place, on its own batch."""
    jtask, ttask = tasks[True]
    thetas = torch.from_numpy(_thetas(jtask, 31))
    idx = torch.from_numpy(_batches(31, seed=2))
    whole = ttask.rollout(thetas, idx)["fitness"]
    for lo in (0, 26, 28):
        part = ttask.rollout(thetas[lo:lo + 3], idx[lo:lo + 3])["fitness"]
        assert torch.equal(part, whole[lo:lo + 3])


# ---- sensitivity -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["SM-G-SUM", "SM-G-ABS"])
@VBN
def test_sensitivities_match_jax(tasks, vbn, kind):
    """``calc_sensitivity`` through MnistTask's forward (the raw logits)
    within rtol 2e-4, atol 1e-6 of JAX's on 8 rows; ``calc_sensitivities``
    of 3 parents (one vmap group of SENS_GROUP) gives each parent's row
    within rtol 1e-5 of it, the same bits wherever the parent sits."""
    from nes_img_captioning_tpu.ops import sensitivity as jsens
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind

    jtask, ttask = tasks[vbn]
    thetas = _thetas(jtask, 3, scale=2.0)
    idx = np.arange(8)
    want = np.asarray(jsens.calc_sensitivity(
        jtask, jnp.asarray(thetas[0]), jnp.asarray(idx), JKind(kind),
        UNDERFLOW))
    idx_t = torch.from_numpy(idx)
    got = tsens.calc_sensitivity(ttask, torch.from_numpy(thetas[0]), idx_t,
                                 MutationKind(kind), UNDERFLOW)
    np.testing.assert_allclose(got.numpy(), want, rtol=SENS_RTOL,
                               atol=SENS_ATOL)
    assert (want > 1).mean() > 0.2
    th = torch.from_numpy(thetas)
    rows = tsens.calc_sensitivities(ttask, th, idx_t, MutationKind(kind),
                                    UNDERFLOW)
    torch.testing.assert_close(rows[0], got, rtol=1e-5, atol=1e-6)
    moved = tsens.calc_sensitivities(ttask, th[[2, 0]], idx_t,
                                     MutationKind(kind), UNDERFLOW)
    assert torch.equal(moved[1], rows[0]) and torch.equal(moved[0], rows[2])


def test_sensitivity_bf16_runs_under_autocast(tasks):
    """SM-G-SUM with tpu.sensitivity_precision bfloat16: the products take
    bf16 operands, the result stays f32 and finite, near the f32 sweep
    where the sensitivity is large (vbn off)."""
    jtask, ttask = tasks[False]
    theta = torch.from_numpy(_thetas(jtask, 1, scale=2.0)[0])
    idx = torch.arange(8)
    kind = MutationKind.SAFE_GRAD_SUM
    f32 = tsens.calc_sensitivity(ttask, theta, idx, kind, UNDERFLOW)
    bf16 = tsens.calc_sensitivity(ttask, theta, idx, kind, UNDERFLOW,
                                  "bfloat16")
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    big = f32 > 2
    assert big.any()
    rel = ((bf16 - f32).abs() / f32)[big]
    assert float(rel.median()) < 0.05


def test_make_task_and_engines_take_mnist(tasks, tmp_path, caplog):
    """make_task builds MnistTask (also from handed-in arrays); NESEngine
    takes it on the torch-order path with the pair kernel and kernel noise
    off (an explicit true warns), ESEngine on its torch-order sweep."""
    import logging

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import SGD
    from nes_img_captioning_tpu_torch.data.mnist import load_mnist
    from nes_img_captioning_tpu_torch.tasks import make_task
    from nes_img_captioning_tpu_torch.tasks.classification import MnistTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = _exp(False, data_root=str(tmp_path))
    data = load_mnist(str(tmp_path), synthetic_sizes=(32, 16), seed=0)
    task = make_task(exp, Config(batch_size=4), parse_tpu_config(exp),
                     device="cpu", data=data)
    assert isinstance(task, MnistTask) and task.train_n == 32
    assert task.artifact_is_fitness and not task.samples
    assert task.sensitivity_groups == 10
    with caplog.at_level(logging.WARNING):
        eng = NESEngine(task, SGD(1.0), MutationKind.DEFAULT,
                        kernel_perturb=True, kernel_noise=True)
    assert eng._layout is None and not eng._kernel_perturb
    assert not eng._kernel_noise
    assert "kernel_perturb=true" in caplog.text
    assert "kernel_noise=true" in caplog.text
    assert eng.normal_of(5).shape == (task.spec.num_params,)
    ESEngine(task, MutationKind.SAFE_GRAD_SUM)
    assert tasks[True][1].spec.num_params == 8550
