"""How far two f32 greedy decodes sit from an f64 replay of their tokens, at
random and at XENT-trained weights, on the CPU: the JAX package's XLA decode
(``FCCaptionModel.sample``) and the port's plain twin of K1
(``decode_cuda.decode_fused_plain``). The evidence behind the f32 lp bar at
trained weights (ROADMAP, ground rules; ``chip_smoke.py`` [28]).

    JAX_PLATFORMS=cpu python tests/f64_lp_replay.py [WIDTH STEPS LR VOCAB
                                                     FEAT N_TRAIN N_TEST]

Defaults: 32 400 3e-3 50 64 512 256 (seconds). ``128 3000 5e-4 9487 2048
2048 1024`` is [28]'s shape (tens of minutes on 4 threads). The theta is
trained by the port's ``pretrain_xent`` on synthetic 9-token captions; both
decodes run at f32; the distance is the largest |lp - lp64| over each row's
steps up to its EOS, on rows whose tokens agree. Not collected by pytest:
a measurement, not a check.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp


def main(argv) -> None:
    jax.config.update("jax_platforms", "cpu")
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from nes_img_captioning_tpu.models.fc_caption import (
        FCCaptionModel as JModel,
        FCModelOptions as JOpts,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.pretrain import pretrain_xent
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    defaults = (32, 400, 3e-3, 50, 64, 512, 256)
    W, steps, lr, V, F, n_train, n_test = [
        type(d)(a) for d, a in zip(defaults, argv)] + list(
        defaults[len(argv):])
    torch.set_num_threads(4)
    copts = make_synthetic_coco(tempfile.mkdtemp(), n_train=n_train, n_val=8,
                                n_test=n_test, vocab_size=V, fc_feat_size=F,
                                cap_len=9)
    exp = {"dataset": "mscoco", "caption_options": dict(copts),
           "policy_options": {"fitness": "greedy", "vbn": False,
                              "model_options": {"input_encoding_size": W,
                                                "rnn_size": W,
                                                "fc_feat_size": F}},
           "tpu": {"seed": 0}}
    task = CocoTask(exp, Config(batch_size=64, val_batch_size=8,
                                num_val_items=8), parse_tpu_config(exp),
                    device="cpu")
    o = task.model.options
    jm = JModel(JOpts(vocab_size=o.vocab_size, input_encoding_size=W,
                      rnn_size=W, fc_feat_size=F))
    feats = task.test_fc.float()
    for name, n in (("random", 0), ("xent", steps)):
        theta = (pretrain_xent(task, steps=n, lr=lr, log_every=0) if n else
                 task.generate_theta(torch.Generator().manual_seed(0)))
        seq_j, lp_j = jm.sample(jnp.asarray(theta.numpy()),
                                jnp.asarray(feats.numpy()), greedy=True)
        seq_j, lp_j = np.asarray(seq_j), np.asarray(lp_j)
        params = dc.prepare_decode_params(task.spec, theta, o)
        seq_p, lp_p = dc.decode_fused_plain(params, feats, o.seq_length,
                                            True)
        # the f64 replay along the twin's tokens (0 after a row's EOS)
        p = task.model.spec.unravel(theta.double())
        N = feats.shape[0]
        with torch.no_grad():
            h = c = torch.zeros((N, W), dtype=torch.float64)
            _, h, c = task.model.lstm_core(
                p, task.model._img_embed(p, feats.double()), h, c)
            it = torch.zeros(N, dtype=torch.long)
            lps = []
            for t in range(o.seq_length):
                out, h, c = task.model.lstm_core(p, task.model._embed(p, it),
                                                 h, c)
                lps.append(task.model._logprobs(p, out).max(-1).values)
                it = seq_p[:, t].long()
            lp64 = torch.stack(lps, -1).numpy()
        T = o.seq_length
        eos = np.argmax(np.concatenate([seq_p.numpy() == 0,
                                        np.ones((N, 1), bool)], 1), 1)
        same = (seq_j == seq_p.numpy()).all(1)
        keep = (np.arange(T)[None, :] <= eos[:, None]) & same[:, None]
        err_j = np.abs(lp_j.astype(np.float64) - lp64)[keep].max()
        err_p = np.abs(lp_p.numpy().astype(np.float64) - lp64)[keep].max()
        print(f"E = R = {W}, vocab {V}, {F}-d, {name} ({n} XENT steps): "
              f"{N} rows, {same.sum()} token-equal; max |lp - f64 replay|: "
              f"JAX XLA f32 {err_j:.3g}, port plain twin {err_p:.3g}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
