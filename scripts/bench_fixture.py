"""The bench settings on the in-memory synthetic fixture, for the scripts that
drive the port on a card: ``chip_smoke.py`` and
``scripts/torch_kernel_ab.py`` build their task, generation inputs and
kernel-noise engine here, so both time the same path.

Shapes are ``bench.py``'s: fc_caption with vocab 9487, E = R = 128,
2048-d features, bf16 weights and deltas, 144 pairs, batch 128,
``pop_chunk`` 24, Adam, sigma 0.01; 2048 train, 256 val and 256 test images
with 9-token captions, made from seed 0. The package is imported when a
function runs, from whichever checkout is first on ``sys.path``.
"""

from __future__ import annotations

import numpy as np

BENCH = dict(pairs=144, batch=128, pop_chunk=24, sigma=0.01, stepsize=0.001,
             l2coeff=1e-7, gens=3)


def bench_task(device, fitness: str = "greedy", data=None, **tpu):
    """The ``CocoTask`` of fitness kind ``fitness`` at the bench settings, on
    ``data`` (another task's, to share it) or on a new fixture; ``tpu``
    overrides ``TpuConfig`` fields."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    if data is None:
        data = CocoData.from_arrays(synthetic_coco_arrays(
            n_train=2048, n_val=256, n_test=256, vocab_size=9487,
            fc_feat_size=2048, cap_len=9, seed=0))
    exp = {"dataset": "mscoco", "policy_options": {
        "fitness": fitness, "vbn": False, "model_options": {
            "input_encoding_size": 128, "rnn_size": 128,
            "fc_feat_size": 2048}}}
    return CocoTask(exp, Config(batch_size=BENCH["batch"]),
                    TpuConfig(seed=0, precision="bf16", delta_dtype="bf16",
                              **tpu), device=device, data=data)


def generation_inputs(task, gens: int):
    """(seeds (gens, pairs) uint32, batches (gens, pairs, batch)) from seed
    0: the pairs' noise seeds and their image indices."""
    from nes_img_captioning_tpu_torch.data.core import EpochSampler

    F, B = BENCH["pairs"], BENCH["batch"]
    rng = np.random.default_rng(0)
    sampler = EpochSampler(task.train_n, seed=0)
    seeds = rng.integers(0, 2**32, size=(gens, F), dtype=np.uint32)
    batches = np.stack([sampler.member_batches(F, B) for _ in range(gens)])
    return seeds, batches


def noise_engine(task):
    """The ``NESEngine`` of ``tpu.kernel_noise``: K5 decodes each chunk of
    pairs from their seeds, K6 draws the gradient again."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    return NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                     pop_chunk=BENCH["pop_chunk"], kernel_perturb=True,
                     kernel_noise=True, delta_dtype="bf16")
