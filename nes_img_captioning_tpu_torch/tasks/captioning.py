"""MSCOCO captioning task (port of ``CocoTask`` in ``nes_img_captioning_tpu/tasks/captioning.py``).

The port runs the greedy fitness kind on the decode-layout path: the
rollouts decode with the kernels of ops/decode_cuda.py (K1 per member, K2
per antithetic pair, K5 per pair with the noise drawn in the kernel) and
score every row with the on-device CIDEr-D; fitness = mean CIDEr-D * 100 per
member (reference: src/captioning/policies.py). Batches are image-level:
greedy decoding of the reference's 5 identical rows per image gives 5
identical captions, so each image is decoded once. Host validation decodes
the val split with K1 and scores it with word-level plain CIDEr. Sampling
kinds, self-critical baselines, the per-token criteria and validation fused
into the generation wait for later slices.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from .base import Task
from ..data.mscoco import CocoData
from ..fitness.scorer import IndexedCiderScorer
from ..models.fc_caption import FCCaptionModel, FCModelOptions
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["CocoTask"]


class CocoTask(Task):
    artifact_is_fitness = False

    def __init__(self, exp: dict, config, tpu_cfg, device=None,
                 data: CocoData | None = None):
        """``data`` (a CocoData) skips reading ``caption_options`` files —
        the in-memory fixture path. ``device`` defaults to the card."""
        self.device = resolve_device(device)
        popts = exp.get("policy_options", {})
        mopts = dict(popts.get("model_options", {}))
        copts = dict(exp.get("caption_options", {}))
        self.config = config
        self.fitness_kind = popts.get("fitness") or "greedy"
        if self.fitness_kind != "greedy":
            raise NotImplementedError(
                f"fitness {self.fitness_kind!r} is not ported yet (greedy "
                "CIDEr-D only)")
        self.data = data if data is not None else CocoData(
            copts, train_only=copts.get("train_only") or 0)
        self.model = FCCaptionModel(FCModelOptions(
            vocab_size=self.data.vocab_size,
            seq_length=self.data.seq_length,
            input_encoding_size=mopts.get("input_encoding_size") or 128,
            rnn_size=mopts.get("rnn_size") or 128,
            fc_feat_size=mopts.get("fc_feat_size") or 2048,
            vbn=bool(popts.get("vbn", False)),
            vbn_e=bool(mopts.get("vbn_e", False)),
            vbn_affine=bool(mopts.get("vbn_affine", False)),
            layer_n=bool(mopts.get("layer_n", False)),
            layer_n_affine=bool(mopts.get("layer_n_affine", False)),
        ), device="meta")  # the task needs the spec; members are flat thetas

        self.train_fc = torch.as_tensor(self.data.split_feats("train"),
                                        device=self.device)
        self.val_fc = torch.as_tensor(self.data.split_feats("val"),
                                      device=self.device)
        self.train_gts = self.data.split_gts("train")
        self._val_scorer = None
        # predictions artifact destination; absent when the task is built
        # without a run (tests, chip_smoke's kernel phases)
        self._eval_dir = (os.path.join(exp["log_dir"], "eval")
                          if exp.get("log_dir") else None)

        self._fused = tpu_cfg.fused_decode is not False
        self._decode_dtype = (torch.bfloat16 if tpu_cfg.precision == "bf16"
                              else torch.float32)

        self._device_cider = None
        if tpu_cfg.device_cider is not False:
            if self.data.vocab_size + 1 >= (1 << 14):
                raise ValueError("vocab too large for the device CIDEr-D")
            from ..ops.cider_device import DeviceCider

            logger.info("building on-device CIDEr-D scorer (%d train images)",
                        len(self.train_gts))
            self._device_cider = DeviceCider(self.train_gts,
                                             variant="cider-d",
                                             device=self.device)

        self.decode_layout = None
        if self._fused and self._device_cider is not None:
            from ..ops.decode_layout import DecodeLayout

            self.decode_layout = DecodeLayout(self.spec, self.model.options)

    @property
    def val_scorer(self) -> IndexedCiderScorer:
        """Plain CIDEr with corpus DF over the val refs, scored at the WORD
        level (token ids remapped so duplicate word strings collapse, as
        pycocoevalcap's string scoring does) — the metric the reference
        reports for eval_split (captioning/eval_utils.py:30-57)."""
        if self._val_scorer is None:
            self._val_scorer = IndexedCiderScorer(
                self.data.split_gts_words("val"), variant="cider")
        return self._val_scorer

    @property
    def fitness_on_device(self) -> bool:
        return self._device_cider is not None

    @property
    def train_n(self) -> int:
        return self.data.split_len("train")

    @property
    def supports_pair_perturb(self) -> bool:
        """Gate for the pair kernel (tpu.kernel_perturb): fused decode and
        device scoring, i.e. the decode layout (the only fitness kind
        ported, greedy, is one the pair kernel serves)."""
        return self.decode_layout is not None

    @property
    def supports_kernel_noise(self) -> bool:
        """Gate for in-kernel noise (tpu.kernel_noise): the pair kernel's
        gate, nothing more. Unlike the JAX gate, which needs a TPU (its
        hardware PRNG has no CPU lowering), the CPU runs the plain versions
        of K5 and K6, which reproduce the kernels' stream exactly."""
        return self.supports_pair_perturb

    def device_consts(self) -> dict:
        c = {"train_fc": self.train_fc}
        if self._device_cider is not None:
            c["cider"] = self._device_cider.dev
        return c

    def generate_theta(self, generator: torch.Generator):
        return self.spec.init_theta(generator, device=self.device)

    # ---- device rollout -----------------------------------------------------------

    def pair_base_params(self, base_dec) -> dict:
        """Decode-ordered base theta -> the f32 params dict of the pair
        kernel, built once per generation."""
        return self.decode_layout.prep(base_dec, torch.float32)

    def rollout_pair_dec(self, base_params: dict, delta_dec, idx,
                         consts=None):
        """Both rollouts of antithetic pairs, the perturbation applied in
        the kernel (K2): delta_dec (P, dim_dec) in its storage dtype, idx
        (P, B). One launch for the P pairs. Returns (P, 2) [pos, neg]
        fitnesses."""
        from ..ops.decode_cuda import decode_pair_perturb

        consts = self.device_consts() if consts is None else consts
        feats = consts["train_fc"][idx]
        seq2, _ = decode_pair_perturb(
            # the delta keeps its own dtype into the kernel; the kernel's
            # f32 + f32(delta) sum is the per-member path's base + delta
            base_params, self.decode_layout.prep(delta_dec, delta_dec.dtype),
            feats, seq_length=self.model.options.seq_length,
            dtype=self._decode_dtype, need_logprobs=False)
        return self._pair_fitness(seq2, idx, consts)

    def rollout_pair_rng(self, base_params: dict, scale_params: dict, seeds,
                         idx, consts=None):
        """rollout_pair_dec with each pair's delta drawn in the kernel (K5)
        from its seed: only the P uint32 seeds go in, the f32 delta never
        exists outside the kernel's scratch. seeds (P,) host uint32, idx
        (P, B). One launch for the P pairs. Returns (P, 2) [pos, neg]
        fitnesses."""
        from ..ops.decode_cuda import decode_pair_rng

        consts = self.device_consts() if consts is None else consts
        seq2, _ = decode_pair_rng(
            base_params, scale_params, seeds, consts["train_fc"][idx],
            seq_length=self.model.options.seq_length,
            dtype=self._decode_dtype, need_logprobs=False)
        return self._pair_fitness(seq2, idx, consts)

    def _pair_fitness(self, seq2, idx, consts):
        """(P, 2, B, T) tokens of P pairs -> (P, 2) [pos, neg] fitnesses,
        the rows laid out as the per-member path lays them out."""
        P = seq2.shape[0]
        return self._device_fitness(
            seq2.reshape(2 * P, *seq2.shape[2:]), idx.repeat_interleave(2, 0),
            consts.get("cider")).reshape(P, 2)

    def rollout_dec(self, vec_dec, idx, consts=None):
        """Greedy rollouts of decode-ordered members (K1, one launch):
        vec_dec (M, dim_dec), idx (M, B). Returns (M,) fitnesses."""
        from ..ops.decode_cuda import decode_fused

        consts = self.device_consts() if consts is None else consts
        seq, _ = decode_fused(
            self.decode_layout.prep(vec_dec, self._decode_dtype),
            consts["train_fc"][idx], seq_length=self.model.options.seq_length,
            need_logprobs=False)
        return self._device_fitness(seq, idx, consts.get("cider"))

    def _device_fitness(self, seq, idx, dev=None):
        """seq (N, B, T) tokens of N members, idx (N, B) their images ->
        (N,) mean CIDEr-D * 100. Both eval paths call this with the same
        layout, so equal tokens give bitwise equal fitnesses."""
        N, B, T = seq.shape
        scores = self._device_cider.score_rows(
            seq.reshape(N * B, T).to(torch.int32), idx.reshape(-1), dev=dev)
        return scores.reshape(N, B).mean(-1) * 100.0

    # ---- validation ------------------------------------------------------------------

    def _decode_split(self, theta, feats, num: int, bs: int) -> np.ndarray:
        """Greedy-decode the first ``num`` rows of a split (all for -1, 0 or
        None) with K1, in launches of at most ``bs`` rows and at most the
        kernel's 128. Greedy rows are independent, so the chunking changes
        no token."""
        from ..ops.decode_cuda import (
            KERNEL_WIDTH,
            decode_fused,
            prepare_decode_params,
        )

        n = feats.shape[0] if num in (-1, None, 0) else min(num,
                                                            feats.shape[0])
        rows = max(min(bs, n, KERNEL_WIDTH), 1)
        params = prepare_decode_params(self.spec, theta, self.model.options,
                                       dtype=self._decode_dtype)
        seqs = [decode_fused(params, feats[s:s + rows],
                             seq_length=self.model.options.seq_length,
                             need_logprobs=False)[0]
                for s in range(0, n, rows)]
        return torch.cat(seqs).cpu().numpy()

    def _write_predictions(self, seqs: np.ndarray, split: str):
        """Reference-shaped predictions artifact: eval_cache_{split}.json =
        [{"image_id", "caption"}, ...] in the run's eval dir (reference:
        src/captioning/eval_utils.py:37-46)."""
        if not self._eval_dir:
            return
        os.makedirs(self._eval_dir, exist_ok=True)
        ids = self.data.split_image_ids(split)
        preds = [{"image_id": ids[i], "caption": cap}
                 for i, cap in enumerate(self.data.decode_sequence(seqs))]
        with open(os.path.join(self._eval_dir, f"eval_cache_{split}.json"),
                  "w") as f:
            json.dump(preds, f)

    def validate(self, theta) -> float:
        """Word-level plain CIDEr of theta's greedy captions over the first
        config.num_val_items val images (captioning.py:617-625 of the JAX
        package)."""
        bs = self.config.val_batch_size or self.config.batch_size or 64
        num = self.config.num_val_items or -1
        seqs = self._decode_split(theta, self.val_fc, num, bs)
        self._write_predictions(seqs, "val")
        mean, _ = self.val_scorer.score(self.data.word_id_rows(seqs),
                                        np.arange(len(seqs)))
        return float(mean)
