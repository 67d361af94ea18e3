"""MSCOCO captioning task (port of ``CocoTask`` in ``nes_img_captioning_tpu/tasks/captioning.py``).

The port runs every fitness kind of the reference (src/captioning/
policies.py, Fitness) on the decode-layout path, scored by the on-device
CIDEr-D:

* greedy | sample        -> mean CIDEr-D * 100 per member;
* self_critical          -> mean(CIDEr-D(sample) - CIDEr-D(greedy)) * 100;
* sc_loss, greedy_*prob  -> the per-token criterion of fitness/criteria.py
                            (sc_loss on samples with the self-critical
                            reward).

The rollouts decode with the kernels of ops/decode_cuda.py: K1 per member
(K4 with ``tpu.decode_vocab_tile``), K2 per antithetic pair, K5 per pair
with the noise drawn in the kernel, and K3 for the sampling kinds. NIC-ES
hands ``rollout`` its children in torch order; they are laid out in decode
order (``to_dec``) and decoded per member like NES's. Greedy
batches are image-level: greedy decoding of the reference's 5 identical
rows per image gives 5 identical captions, so each image is decoded once.
The sampling kinds draw ``seq_per_img`` (default 5) independent samples per
image, rows image-major (row ``b * spi + i``), as the reference's
``repeat(feats, 5)``. A batch above the kernels' 128 rows is decoded in
row blocks of at most 128, one launch each (K3's blocks draw the Gumbel
stream of one launch over all rows). Validation decodes the val subset
with one launch of K1 (K4 when tiled) over all its row blocks
(``decode_rows``) and scores it with word-level plain CIDEr: on the host
with the native scorer (``validate``, which also writes the predictions
JSON), or on the card (``validate_device`` on ``device_val_consts``, no
host sync), which ``tpu.fused_validation`` runs inside the master's
blocks.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from .base import Task
from ..data.mscoco import CocoData
from ..fitness.criteria import FITNESS_CRITERIA, criterion_device
from ..fitness.scorer import IndexedCiderScorer
from ..models.fc_caption import FCCaptionModel, FCModelOptions
from ..ops.decode_cuda import KERNEL_WIDTH, PAD_LANE, pad_vocab
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["CocoTask", "GREEDY_KINDS", "SELF_CRITICAL_KINDS"]

# reference classification of fitness kinds (captioning/policies.py:40-47)
GREEDY_KINDS = {"greedy", "greedy_logprob", "greedy_expprob", "greedy_linprob",
                "greedy_avgprob"}
SELF_CRITICAL_KINDS = {"self_critical", "sc_loss"}
_KINDS = GREEDY_KINDS | SELF_CRITICAL_KINDS | {"sample"}


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
        if self.fitness_kind not in _KINDS:
            raise ValueError(f"unknown fitness {self.fitness_kind!r}: "
                             f"expected one of {sorted(_KINDS)}")
        self.seq_per_img = copts.get("seq_per_img") or 5
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
        o = self.model.options
        if self.device.type == "cuda" and not (
                o.input_encoding_size == o.rnn_size == KERNEL_WIDTH
                and o.fc_feat_size % KERNEL_WIDTH == 0):
            raise ValueError(
                f"input_encoding_size={o.input_encoding_size}, rnn_size="
                f"{o.rnn_size}, fc_feat_size={o.fc_feat_size}: the CUDA "
                f"decode kernels take E = R = {KERNEL_WIDTH} and a feature "
                f"width that is a multiple of {KERNEL_WIDTH}")

        self.train_fc = torch.as_tensor(self.data.split_feats("train"),
                                        device=self.device)
        self.val_fc = torch.as_tensor(self.data.split_feats("val"),
                                      device=self.device)
        self.train_gts = self.data.split_gts("train")
        self._train_scorer = self._val_scorer = None
        self._val_dev_cache = None
        # predictions artifact destination; absent when the task is built
        # without a run (tests, chip_smoke's kernel phases)
        self._eval_dir = (os.path.join(exp["log_dir"], "eval")
                          if exp.get("log_dir") else None)

        self._fused = tpu_cfg.fused_decode is not False
        self._decode_dtype = (torch.bfloat16 if tpu_cfg.precision == "bf16"
                              else torch.float32)
        # SM-G's vocab grouping of the sensitivity forward (reference: 100)
        self._sens_split = int(tpu_cfg.sensitivity_split or 100)
        # the vocab-tiled greedy decode (K4) for every greedy decode
        self._vocab_tile = int(tpu_cfg.decode_vocab_tile or 0)
        Vpad = pad_vocab(self.data.vocab_size + 1)
        if self._vocab_tile and (self._vocab_tile < 0
                                 or self._vocab_tile % PAD_LANE
                                 or Vpad % self._vocab_tile):
            raise ValueError(
                f"tpu.decode_vocab_tile={self._vocab_tile}: expected a "
                f"multiple of {PAD_LANE} dividing the padded vocab {Vpad}")

        # the reference's frozen DF table, CiderD(df='coco-train-idxs')
        # (src/captioning/policies.py:72): caption_options.cider_df names
        # the pickle (fitness/ciderd.py load_df_pickle); unset, the DF is
        # fitted on the train ground truths
        self._frozen_df = None
        if copts.get("cider_df"):
            from ..fitness.ciderd import load_df_pickle

            self._frozen_df = load_df_pickle(copts["cider_df"])
            logger.info(
                "loaded frozen CIDEr-D DF table %s (%d n-grams, ref_len "
                "%.4f)", copts["cider_df"],
                sum(len(d) for d in self._frozen_df[0]), self._frozen_df[1])

        self._device_cider = None
        if tpu_cfg.device_cider is not False:
            if self.data.vocab_size + 1 >= (1 << 14):
                raise ValueError("vocab too large for the device CIDEr-D")
            from ..ops.cider_device import DeviceCider

            logger.info("building on-device CIDEr-D scorer (%d train images)",
                        len(self.train_gts))
            self._device_cider = DeviceCider(self.train_gts,
                                             variant="cider-d",
                                             frozen_df=self._frozen_df,
                                             device=self.device)

        self.decode_layout = None
        if self._fused and self._device_cider is not None:
            from ..ops.decode_layout import DecodeLayout

            self.decode_layout = DecodeLayout(self.spec, self.model.options)

    @property
    def train_scorer(self) -> IndexedCiderScorer:
        """CIDEr-D with DF fitted over the train ground truths (or the
        frozen ``caption_options.cider_df`` table) on the native scorer: the
        host counterpart of the device CIDEr-D (JAX: captioning.py:
        190-201)."""
        if self._train_scorer is None:
            self._train_scorer = IndexedCiderScorer(
                self.train_gts, variant="cider-d", frozen_df=self._frozen_df)
        return self._train_scorer

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
        device scoring (the decode layout), a greedy fitness kind (the
        sampling kinds draw per-lane seeds the pair kernel does not take),
        and the untiled logit pass — the JAX gate
        (captioning.py:321-334)."""
        return (self.decode_layout is not None
                and self.fitness_kind in GREEDY_KINDS
                and not self._vocab_tile)

    @property
    def need_logprobs(self) -> bool:
        """Only the per-token criteria kinds consume logprobs; the others
        skip the decode's log-softmax reductions."""
        return self.fitness_kind in FITNESS_CRITERIA

    @property
    def samples(self) -> bool:
        """The kind decodes seq_per_img sampled lanes per image (K3)."""
        return self.fitness_kind not in GREEDY_KINDS

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

    @staticmethod
    def _by_rows(decode, B: int, axis: int):
        """``decode(lo, hi)`` on row blocks [lo, hi) of at most the kernels'
        128 rows, one launch each, its (seq, lp) joined along ``axis``.
        Rows are independent but for the batch-wide early exit, which only
        skips steps whose tokens are 0 anyway, so no token changes."""
        outs = [decode(lo, min(lo + KERNEL_WIDTH, B))
                for lo in range(0, B, KERNEL_WIDTH)]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(o, axis) for o in zip(*outs))

    def rollout_pair_dec(self, base_params: dict, delta_dec, idx,
                         consts=None):
        """Both rollouts of antithetic pairs, the perturbation applied in
        the kernel (K2): delta_dec (P, dim_dec) in its storage dtype, idx
        (P, B). One launch for the P pairs per block of 128 rows. Returns
        (P, 2) [pos, neg] fitnesses."""
        from ..ops.decode_cuda import decode_pair_perturb

        consts = self.device_consts() if consts is None else consts
        feats = consts["train_fc"][idx]
        # the delta keeps its own dtype into the kernel; the kernel's f32 +
        # f32(delta) sum is the per-member path's base + delta
        delta = self.decode_layout.prep(delta_dec, delta_dec.dtype)
        seq2, lp2 = self._by_rows(lambda lo, hi: decode_pair_perturb(
            base_params, delta, feats[:, lo:hi],
            seq_length=self.model.options.seq_length,
            dtype=self._decode_dtype, need_logprobs=self.need_logprobs),
            idx.shape[-1], 2)
        return self._pair_fitness(seq2, lp2, idx, consts)

    def rollout_pair_rng(self, base_params: dict, scale_params: dict, seeds,
                         idx, consts=None):
        """rollout_pair_dec with each pair's delta drawn in the kernel (K5)
        from its seed: only the P uint32 seeds go in, the f32 delta never
        exists outside the kernel's scratch. seeds (P,) host uint32, idx
        (P, B). One launch for the P pairs per block of 128 rows (each draws
        the deltas again). Returns (P, 2) [pos, neg] fitnesses."""
        from ..ops.decode_cuda import decode_pair_rng

        consts = self.device_consts() if consts is None else consts
        feats = consts["train_fc"][idx]
        seq2, lp2 = self._by_rows(lambda lo, hi: decode_pair_rng(
            base_params, scale_params, seeds, feats[:, lo:hi],
            seq_length=self.model.options.seq_length,
            dtype=self._decode_dtype, need_logprobs=self.need_logprobs),
            idx.shape[-1], 2)
        return self._pair_fitness(seq2, lp2, idx, consts)

    def _pair_fitness(self, seq2, lp2, idx, consts):
        """(P, 2, B, T) tokens and logprobs of P pairs -> (P, 2) [pos, neg]
        fitnesses, the rows laid out as the per-member path lays them
        out."""
        P = seq2.shape[0]
        return self._device_fitness(
            seq2.reshape(2 * P, *seq2.shape[2:]), idx.repeat_interleave(2, 0),
            consts.get("cider"),
            lp=lp2.reshape(2 * P, *lp2.shape[2:])).reshape(P, 2)

    def _greedy(self, params: dict, feats, need_logprobs: bool = False):
        """Greedy decode of a batch of members (feats (M, B, F)) or of one
        (feats (B, F)): K1, or K4 with tpu.decode_vocab_tile, in blocks of
        at most 128 rows."""
        from ..ops.decode_cuda import decode_fused

        return self._by_rows(lambda lo, hi: decode_fused(
            params, feats[..., lo:hi, :], self.model.options.seq_length,
            need_logprobs, vocab_tile=self._vocab_tile), feats.shape[-2], -2)

    def _sample(self, params: dict, feats, lanes):
        """K3 on a batch of members, feats (M, B, F), in blocks of at most
        128 rows: ``lanes`` (M, spi) uint32 lane seeds, each block drawing
        at its row offset, or an (M, spi, T, B, Vpad) f32 Gumbel table,
        sliced by row. Returns (seq, lp), each (M, spi, B, T)."""
        from ..ops.decode_cuda import decode_fused

        def block(lo, hi):
            if torch.is_tensor(lanes):
                noise = {"gumbel": lanes[..., lo:hi, :].contiguous()}
            else:
                noise = {"seeds": lanes, "row0": lo}
            return decode_fused(params, feats[:, lo:hi],
                                self.model.options.seq_length,
                                self.need_logprobs, greedy=False, **noise)

        return self._by_rows(block, feats.shape[1], 2)

    def rollout_dec(self, vec_dec, idx, consts=None, lanes=None):
        """Rollouts of decode-ordered members, one launch per decode and
        block of 128 rows: vec_dec (M, dim_dec), idx (M, B). Greedy kinds
        decode each member's B rows once (K1, or K4 when tiled). The
        sampling kinds decode seq_per_img lanes per member with K3,
        ``lanes`` giving their noise: (M, spi) uint32 lane seeds (host), or
        an (M, spi, T, B, Vpad) f32 Gumbel table (K3's host-table form); the
        self-critical kinds also decode each member greedily for the
        baseline. Returns (M,) fitnesses."""
        consts = self.device_consts() if consts is None else consts
        params = self.decode_layout.prep(vec_dec, self._decode_dtype)
        feats = consts["train_fc"][idx]
        T = self.model.options.seq_length
        base = None
        if not self.samples:
            seq, lp = self._greedy(params, feats, self.need_logprobs)
        else:
            if lanes is None:
                raise ValueError(f"fitness {self.fitness_kind!r} samples: "
                                 "rollout_dec needs its lanes' noise")
            seq, lp = self._sample(params, feats, lanes)  # (M, spi, B, T)
            M, spi, B = seq.shape[:3]
            # image-major rows b * spi + i
            seq = seq.transpose(1, 2).reshape(M, B * spi, T)
            lp = lp.transpose(1, 2).reshape(M, B * spi, T)
            if self.fitness_kind in SELF_CRITICAL_KINDS:
                base = self._greedy(params, feats)[0]
        return self._device_fitness(seq, idx, consts.get("cider"), lp=lp,
                                    base_seq=base)

    def rollout(self, thetas, idx_row, consts=None, lanes=None) -> dict:
        """Rollouts of torch-order members, the NIC-ES sweep (JAX:
        captioning.py:291-325): thetas (M, dim) flat f32, idx_row (B,) the
        generation's batch, shared by every member. The members are laid out
        in decode order by the exact ``decode_layout.to_dec`` and decoded by
        ``rollout_dec`` (K1, K4 when tiled, K3 with ``lanes`` for the
        sampling kinds; row blocks of 128). Returns ``{"fitness": (M,)}``,
        the device scorer's artifact."""
        idx_row = torch.as_tensor(idx_row, device=self.device)
        idx = idx_row.reshape(1, -1).expand(thetas.shape[0], -1)
        return {"fitness": self.rollout_dec(self.decode_layout.to_dec(thetas),
                                            idx, consts=consts, lanes=lanes)}

    def host_fitness(self, artifacts, idx) -> np.ndarray:
        """The fitness array of a sweep's artifacts. The device scorer's
        ``{"fitness": ...}`` passes through; host scoring of token artifacts
        is not ported yet (JAX: captioning.py:528-533)."""
        if isinstance(artifacts, dict) and "fitness" in artifacts:
            f = artifacts["fitness"]
            f = f.detach().cpu().numpy() if torch.is_tensor(f) else f
            return np.asarray(f, np.float32)
        raise NotImplementedError(
            "host-scored fitness (token artifacts) is not ported yet")

    def _device_fitness(self, seq, idx, dev=None, lp=None, base_seq=None):
        """seq (N, R, T) tokens of N members (R = B rows, or B * spi
        image-major sampled rows), idx (N, B) their images -> (N,)
        fitnesses: mean CIDEr-D * 100, or the per-token criterion of the
        criteria kinds (over lp (N, R, T), the row's score as every token's
        reward, not scaled by 100). ``base_seq`` (N, B, T): the greedy
        baseline whose CIDEr-D the self-critical kinds subtract from each
        sample of its image (reference: captioning/policies.py:119-126,
        164-191). Both eval paths call this with the same layout, so equal
        tokens give bitwise equal fitnesses."""
        N, R, T = seq.shape
        B = idx.shape[-1]
        spi = R // B
        cider = self._device_cider
        scores = cider.score_rows(
            seq.reshape(N * R, T).to(torch.int32),
            idx.repeat_interleave(spi, -1).reshape(-1), dev=dev).reshape(N, R)
        if base_seq is not None:
            base = cider.score_rows(
                base_seq.reshape(N * B, T).to(torch.int32), idx.reshape(-1),
                dev=dev).reshape(N, B)
            scores = scores - base.repeat_interleave(spi, -1)
        if self.need_logprobs:
            return criterion_device(self.fitness_kind, lp, seq,
                                    scores[..., None])
        return scores.mean(-1) * 100.0

    # ---- sensitivity -------------------------------------------------------

    @property
    def sensitivity_groups(self) -> int:
        """K, the columns of ``sensitivity_forward``'s output."""
        return (self.data.vocab_size + 1) // self._sens_split + 1

    def sensitivity_forward(self, theta, idx, consts=None):
        """(B, K) grouped logprobs of the flat theta after 5 greedy steps
        on the train images ``idx`` (a long tensor on the task's device),
        differentiable in theta; ``tpu.sensitivity_split`` sets the
        grouping (JAX: captioning.py:740-749)."""
        train_fc = self.train_fc if consts is None else consts["train_fc"]
        return self.model.forward_for_sensitivity(
            theta, train_fc[idx], length=5, split=self._sens_split)

    # ---- validation ------------------------------------------------------------------

    def _val_count(self, feats, num) -> int:
        """Rows of a split that validation decodes: the first ``num`` (all
        for -1, 0 or None)."""
        n = feats.shape[0]
        return n if num in (-1, None, 0) else min(num, n)

    def _decode_rows(self, theta, feats) -> torch.Tensor:
        """Greedy tokens (N, T) of theta on feats (N, F): one launch of K1
        (K4 when tiled) over all row blocks of 128 (``decode_rows``)."""
        from ..ops.decode_cuda import decode_rows, prepare_decode_params

        params = prepare_decode_params(self.spec, theta, self.model.options,
                                       dtype=self._decode_dtype)
        return decode_rows(params, feats, self.model.options.seq_length,
                           False, vocab_tile=self._vocab_tile)[0]

    def _decode_split(self, theta, feats, num: int) -> np.ndarray:
        """Greedy-decode the first ``num`` rows of a split (all for -1, 0 or
        None) in one launch. Greedy rows are independent, so the blocks
        change no token."""
        return self._decode_rows(
            theta, feats[:self._val_count(feats, num)]).cpu().numpy()

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
        config.num_val_items val images, scored on the host by the native
        scorer; writes the predictions JSON (captioning.py:617-625 of the
        JAX package). The chunks of ``val_batch_size`` the JAX package
        decodes change no token here: one launch decodes every row."""
        seqs = self._decode_split(theta, self.val_fc,
                                  self.config.num_val_items or -1)
        self._write_predictions(seqs, "val")
        mean, _ = self.val_scorer.score(self.data.word_id_rows(seqs),
                                        np.arange(len(seqs)))
        return float(mean)

    def device_val_consts(self) -> dict | None:
        """The card's constants of ``validate_device``, built once: the val
        subset's feats in the decode dtype (no padding: the row-block
        launch takes the ragged last block as it is), the token -> word-id
        table of ``data.word_id_rows`` as one flat tensor (gathered with
        ``table[seqs]``), the subset's image indices, and a word-level
        plain-CIDEr DeviceCider over the val refs: validate()'s subset and
        scorer. None when the task has no device CIDEr-D (JAX: captioning.
        py:627-694)."""
        if self._device_cider is None:
            return None
        if self._val_dev_cache is None:
            from ..ops.cider_device import DeviceCider

            n = self._val_count(self.val_fc, self.config.num_val_items or -1)
            logger.info("building on-device val CIDEr scorer (%d images)", n)
            self._val_device_cider = DeviceCider(
                self.data.split_gts_words("val"), variant="cider",
                device=self.device)
            table = self.data.word_id_rows(
                np.arange(self.data.vocab_size + 1))
            self._val_dev_cache = {
                "feats": self.val_fc[:n].to(self._decode_dtype).contiguous(),
                "word": torch.as_tensor(table, dtype=torch.int64,
                                        device=self.device),
                "img": torch.arange(n, device=self.device),
                "cider": self._val_device_cider.dev,
            }
        return self._val_dev_cache

    def validate_device(self, theta, vconsts) -> torch.Tensor:
        """validate() on the card: one row-block decode of the val subset,
        the word-id gather and the word-level plain CIDEr of DeviceCider;
        the mean score as a 0-d f32 tensor on the card, with no host sync
        and no predictions JSON (JAX: captioning.py:696-724). Equal to
        validate() to f32 accuracy."""
        seqs = self._decode_rows(theta, vconsts["feats"])
        wids = vconsts["word"][seqs.clamp(0, self.data.vocab_size).long()]
        return self._val_device_cider.score_rows(
            wids, vconsts["img"], dev=vconsts["cider"]).mean()
