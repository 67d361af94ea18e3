"""Port parity: one whole NIC-NES generation of the port's NESEngine against
the JAX package's, on the same theta, batches and realized deltas.

torch cannot reproduce JAX's noise streams, so the deltas come from JAX
``NESEngine.eval_generation`` and are handed to the port by patching its
per-seed delta function; the JAX update is ``update(deltas=...)``. Both
sides decode with their plain / interpret-mode kernels at f32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

from torch_pin import one_intra_op_thread  # noqa: F401

# l2coeff of the bench. With a large one the Adam step is ill-conditioned
# where -grad/2F cancels l2*theta (globalg ~1e-8, near Adam's epsilon), and
# two f32 sums of the same terms in different orders then differ there by
# more than 1e-6 after the step (measured: 1e-5 at l2coeff 1e-3).
F_PAIRS, B, SIGMA, STEP, L2 = 4, 4, 0.05, 0.01, 1e-7


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX task, engine inputs and outputs (as in
    tests/test_delta_dtype.py: fused decode in interpret mode, f32)."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine
    from nes_img_captioning_tpu.algorithms.optimizers import Adam
    from nes_img_captioning_tpu.ops.mutation import MutationKind
    from nes_img_captioning_tpu.tasks.captioning import CocoTask
    from nes_img_captioning_tpu.utils.config import Config, parse_tpu_config

    d = str(tmp_path_factory.mktemp("coco_gen"))
    copts = make_synthetic_coco(d, n_train=12, n_val=4, n_test=4,
                                vocab_size=40, fc_feat_size=24, cap_len=6,
                                seed=0)
    exp = {
        "dataset": "mscoco",
        "caption_options": copts,
        "policy_options": {"fitness": "greedy", "model_options": {
            "input_encoding_size": 16, "rnn_size": 16, "fc_feat_size": 24,
        }},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"},
    }
    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp))
    task._fused_interpret = True
    eng = NESEngine(task, Adam(STEP), MutationKind.DEFAULT, pop_chunk=2)
    rng = np.random.default_rng(8)
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 12, size=(F_PAIRS, B)).astype(np.int32)
    theta = task.generate_theta(jax.random.PRNGKey(6))
    sens = jnp.ones((eng.dim,), jnp.float32)
    art, deltas = eng.eval_generation(theta, sens, SIGMA, seeds, idx)
    assert deltas is not None
    fitnesses = task.host_fitness(art, idx)
    _, theta_new, ratio = eng.update(
        theta, eng.optimizer.init(eng.dim), sens, SIGMA, seeds, fitnesses,
        STEP, L2, deltas=deltas)
    return {
        "exp": exp, "seeds": seeds, "idx": idx,
        "theta": np.asarray(theta),
        "deltas": np.asarray(deltas).reshape(-1, eng.dim)[:F_PAIRS],
        "fitnesses": np.asarray(fitnesses),
        "theta_new": np.asarray(theta_new),
        "ratio": float(ratio),
        "norm": float(jnp.abs(theta_new).mean()),
    }


def _port_generation(ref, kernel_perturb, delta_dtype="f32"):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = ref["exp"]
    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu")
    assert task.supports_pair_perturb
    eng = NESEngine(task, Adam(STEP), MutationKind.DEFAULT, pop_chunk=2,
                    kernel_perturb=kernel_perturb, delta_dtype=delta_dtype)
    lay = task.decode_layout
    by_seed = {int(s): lay.to_dec(torch.from_numpy(d.copy()), pad_scale=0.0)
               for s, d in zip(ref["seeds"], ref["deltas"])}
    eng.delta_of = lambda scale_dec, seed: by_seed[int(seed)].to(
        eng._delta_dtype)
    theta = torch.from_numpy(ref["theta"].copy())
    th, _, packed = eng.generation(
        theta, eng.optimizer.init(eng.dim, "cpu"), torch.ones_like(theta),
        SIGMA, ref["seeds"], ref["idx"], STEP, L2)
    return th, packed, eng


@pytest.mark.parametrize("kernel_perturb", [True, False],
                         ids=["pair_kernel", "per_member"])
def test_generation_matches_jax(jax_reference, kernel_perturb):
    """Fitnesses within 1e-5, theta after the Adam step within 1e-6 abs,
    ratio and mean|theta| within 1e-6 relative."""
    ref = jax_reference
    th, packed, eng = _port_generation(ref, kernel_perturb)
    assert eng._kernel_perturb is kernel_perturb
    fits, ratio, norm = eng.unpack(packed, F_PAIRS)
    np.testing.assert_allclose(fits, ref["fitnesses"], atol=1e-5)
    assert np.ptp(fits) > 0  # the pairs genuinely differ
    np.testing.assert_allclose(th.numpy(), ref["theta_new"], atol=1e-6)
    np.testing.assert_allclose(ratio, ref["ratio"], rtol=1e-6)
    np.testing.assert_allclose(norm, ref["norm"], rtol=1e-6)


def test_pair_and_per_member_paths_bitwise_equal(jax_reference):
    """The two eval paths feed the scorer the same tensors: equal packed
    vectors and theta, bit for bit, for f32 and bf16 deltas."""
    for ddt in ("f32", "bf16"):
        th_k, packed_k, _ = _port_generation(jax_reference, True, ddt)
        th_m, packed_m, _ = _port_generation(jax_reference, False, ddt)
        assert torch.equal(packed_k, packed_m)
        assert torch.equal(th_k, th_m)


def test_generation_block_and_seeded_noise(jax_reference):
    """generation_block chains generations; without the patch the engine
    draws its own per-seed noise, the same for the same seeds."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    ref = jax_reference
    task = CocoTask(ref["exp"], Config(batch_size=B),
                    parse_tpu_config(ref["exp"]), device="cpu")
    eng = NESEngine(task, Adam(STEP), MutationKind.DEFAULT, pop_chunk=3,
                    delta_dtype="bf16")
    theta = task.generate_theta(torch.Generator().manual_seed(0))
    seeds = np.stack([ref["seeds"], ref["seeds"] + 1])
    idx = np.stack([ref["idx"], ref["idx"]])
    runs = [eng.generation_block(theta, eng.optimizer.init(eng.dim, "cpu"),
                                 torch.ones_like(theta), SIGMA, seeds, idx,
                                 STEP, L2) for _ in range(2)]
    th, state, packs = runs[0]
    assert packs.shape == (2, 2 * F_PAIRS + 2) and int(state.t) == 2
    assert torch.equal(packs, runs[1][2]) and torch.equal(th, runs[1][0])
    assert np.isfinite(packs.numpy()).all() and not torch.equal(th, theta)
    fits, ratio, norm = eng.unpack(packs, F_PAIRS)
    assert fits.shape == (2, F_PAIRS, 2) and ratio.shape == (2,)


def test_entry_points_default_to_the_card():
    """Without device='cpu' an entry point asks for CUDA and raises here."""
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCCaptionModel,
        FCModelOptions,
    )
    from nes_img_captioning_tpu_torch.utils.device import resolve_device

    opts = FCModelOptions(vocab_size=5, input_encoding_size=8, rnn_size=8,
                          fc_feat_size=8)
    makers = (resolve_device, lambda: Adam(0.1).init(4),
              lambda: FCCaptionModel(opts, theta=torch.zeros(
                  FCCaptionModel(opts, device="meta").num_params)))
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    assert resolve_device("cpu").type == "cpu"
    assert Adam(0.1).init(4, "cpu").m.device.type == "cpu"
