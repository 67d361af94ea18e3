"""MSCOCO captioning task (port of ``CocoTask`` in ``nes_img_captioning_tpu/tasks/captioning.py``).

Every fitness kind of the reference (src/captioning/policies.py, Fitness):

* greedy | sample        -> mean CIDEr-D * 100 per member;
* self_critical          -> mean(CIDEr-D(sample) - CIDEr-D(greedy)) * 100;
* sc_loss, greedy_*prob  -> the per-token criterion of fitness/criteria.py
                            (sc_loss on samples with the self-critical
                            reward).

A rollout is a decode and a score, each in one of two forms (JAX:
captioning.py:221-319):

* decode, fused (``tpu.fused_decode``; "auto" takes it for the no-norm
  model, which on the card must have E, R <= 512 unless the knob is false;
  the card lays it out zero-padded at ``kernel_shape``, E and R to the next
  built width of 128, 256 and 512 and F to a multiple of 128, which
  changes no token): the kernels of ops/decode_cuda.py, K1 per member (K4
  with ``tpu.decode_vocab_tile``), K2 per antithetic pair, K5 per pair
  with the noise drawn in the kernel, and K3 for the sampling kinds, in
  launches of at most 128 rows (K3's blocks draw the Gumbel stream of one
  launch over all rows);
* decode, eager: ``FCCaptionModel.sample_members``, f32, the whole batch of
  each member at once, so the vbn, vbn_e and layer_n variants keep their
  batch statistics over all of a member's rows as the JAX decoder does;
* score on the device (``tpu.device_cider``; "auto" unless V + 1 >= 16384):
  the on-device CIDEr-D, the rollout returns ``{"fitness"}``;
* score on the host: the rollout returns the tokens (int16 while V <
  32767), with the logprobs for the criteria kinds and the greedy baseline
  for the self-critical kinds, and ``host_fitness`` scores them on the
  native scorer (``_score_dedup``: each distinct caption of an image once).

NES's decode-order generation (``rollout_dec``, the decode layout) exists
only when the decode is fused and scored on the device; every other
combination rolls out torch-order members (``rollout``). Greedy batches are
image-level: greedy decoding of the reference's 5 identical rows per image
gives 5 identical captions, so each image is decoded once. The sampling
kinds draw ``seq_per_img`` (default 5) samples per image, rows image-major
(row ``b * spi + i``), as the reference's ``repeat(feats, 5)``.

Validation decodes the val subset greedily and scores it with word-level
plain CIDEr: on the host with the native scorer (``validate``, which also
writes the predictions JSON), or on the card (``validate_device`` on
``device_val_consts``, no host sync), which ``tpu.fused_validation`` runs
inside the master's blocks. Fused, one launch of K1 (K4 when tiled) covers
all row blocks (``decode_rows``); eager, the rows are decoded in the JAX
package's chunks of ``val_batch_size``, the ragged tail padded with zero
rows, which the vbn statistics see (``greedy_rows``). ``test_score`` decodes
and scores the whole test split as ``validate`` does the val subset.
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
from ..fitness.criteria import apply_criterion
from ..models.fc_caption import FCCaptionModel, FCModelOptions
from ..ops.decode_cuda import MAX_ROWS, PAD_LANE, kernel_shape, pad_vocab
from ..ops.noise import gumbel_plain
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["CocoTask", "GREEDY_KINDS", "SELF_CRITICAL_KINDS",
           "greedy_rows", "resolve_fused"]

# reference classification of fitness kinds (captioning/policies.py:40-47)
GREEDY_KINDS = {"greedy", "greedy_logprob", "greedy_expprob", "greedy_linprob",
                "greedy_avgprob"}
SELF_CRITICAL_KINDS = {"self_critical", "sc_loss"}
_KINDS = GREEDY_KINDS | SELF_CRITICAL_KINDS | {"sample"}
# the on-device CIDEr-D packs a token into 14 bits (JAX: captioning.py:140)
DEVICE_CIDER_VOCAB = 1 << 14


def resolve_fused(o: FCModelOptions, want, device: torch.device) -> bool:
    """tpu.fused_decode (``want``: "auto", true or false) for a model of
    options ``o`` on ``device``: "auto" takes the kernels for the no-norm
    model and the eager decoder for the vbn, vbn_e and layer_n variants, as
    JAX's ``can_fuse`` does; false takes the eager decoder. True with a
    norm variant raises: JAX's fused path would decode it through
    ``prepare_decode_params``, which drops every norm leaf, another model.
    On the card the kernels take any no-norm model of E, R <= 512 (the
    decode layout zero-pads it to ``kernel_shape``); a wider one raises
    unless fused_decode is false, where JAX would still run its
    kernels."""
    if o.vbn or o.vbn_e or o.layer_n:
        if want is True:
            raise ValueError(
                "tpu.fused_decode=true: the decode kernels run the "
                "no-norm model; the vbn, vbn_e and layer_n variants "
                "decode eagerly, so leave it at \"auto\" or false")
        return False
    if want is False:
        return False
    if device.type == "cuda":
        try:
            kernel_shape(o.input_encoding_size, o.rnn_size, o.fc_feat_size)
        except ValueError as e:
            raise ValueError(f"tpu.fused_decode={want}: {e}") from None
    return True


def greedy_rows(model: FCCaptionModel, theta, feats, fused: bool, dtype,
                chunk: int, vocab_tile: int = 0,
                pad: bool | None = None) -> torch.Tensor:
    """Greedy tokens (N, T) of the flat theta on feats (N, F). Fused: one
    launch of K1 (K4 with ``vocab_tile``) over all row blocks of a cluster
    (``decode_rows``) on ``prepare_decode_params`` at ``dtype``, laid out
    at the kernels' widths when ``pad`` (default: theta on the card);
    greedy rows are independent, so the blocks change no token. Eager
    (``FCCaptionModel.sample_members``, f32): chunks of ``chunk`` rows (at
    most N), the ragged tail padded with zero rows, whose statistics the
    vbn variants see (JAX: captioning.py:577-594). ``CocoTask``'s
    validation and test split and ``eval_on_test`` decode here."""
    if not fused:
        N = feats.shape[0]
        bs = min(chunk, N)
        chunks = []
        for lo in range(0, N, bs):
            rows = feats[lo:lo + bs]
            pad = bs - rows.shape[0]
            rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
            chunks.append(model.sample_members(
                theta[None], rows[None])[0][0, :bs - pad])
        return torch.cat(chunks)
    from ..ops.decode_cuda import decode_rows, prepare_decode_params

    params = prepare_decode_params(model.spec, theta, model.options,
                                   dtype=dtype, pad=pad)
    return decode_rows(params, feats, model.options.seq_length, False,
                       vocab_tile=vocab_tile)[0]


class CocoTask(Task):
    artifact_is_fitness = False

    def __init__(self, exp: dict, config, tpu_cfg, device=None,
                 data: CocoData | None = None, pad: bool | None = None):
        """``data`` (a CocoData) skips reading ``caption_options`` files —
        the in-memory fixture path. ``device`` defaults to the card.
        ``pad``: lay the fused decode out at the kernels' widths
        (``kernel_shape``); default on the card, which takes no other
        layout, and not on the CPU, whose plain twins take any width."""
        self.device = resolve_device(device)
        self._pad = self.device.type == "cuda" if pad is None else pad
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
        self._fused = self._resolve_fused(tpu_cfg.fused_decode)
        self.train_fc = torch.as_tensor(self.data.split_feats("train"),
                                        device=self.device)
        self.val_fc = torch.as_tensor(self.data.split_feats("val"),
                                      device=self.device)
        self.test_fc = torch.as_tensor(self.data.split_feats("test"),
                                       device=self.device)
        self.train_gts = self.data.split_gts("train")
        self.test_gts = self.data.split_gts("test")
        self._train_scorer = self._val_scorer = None
        self._val_dev_cache = None
        # (distinct rows scored, rows) of the last ``_score_dedup``
        self.dedup_rows = (0, 0)
        # predictions artifact destination; absent when the task is built
        # without a run (tests, chip_smoke's kernel phases)
        self._eval_dir = (os.path.join(exp["log_dir"], "eval")
                          if exp.get("log_dir") else None)

        self._decode_dtype = (torch.bfloat16 if tpu_cfg.precision == "bf16"
                              else torch.float32)
        # the host artifact's token dtype (JAX: captioning.py:123-125)
        self._wire_dtype = (torch.int16 if self.data.vocab_size < 32767
                            else torch.int32)
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

        # device scoring: "auto" as the JAX package (captioning.py:136-142);
        # an explicit true the device scorer cannot honour raises where
        # JAX scores on the host instead
        big = self.data.vocab_size + 1 >= DEVICE_CIDER_VOCAB
        if tpu_cfg.device_cider is True and big:
            raise ValueError(
                f"tpu.device_cider=true: vocab {self.data.vocab_size} + 1 is "
                f"too large for the device CIDEr-D (< {DEVICE_CIDER_VOCAB}); "
                "leave it at \"auto\" or false to score on the host")
        self._device_cider = None
        if tpu_cfg.device_cider is not False and not big:
            from ..ops.cider_device import DeviceCider

            logger.info("building on-device CIDEr-D scorer (%d train images)",
                        len(self.train_gts))
            self._device_cider = DeviceCider(self.train_gts,
                                             variant="cider-d",
                                             frozen_df=self._frozen_df,
                                             device=self.device)

        # the kernels' parameter layout; the NES engine's decode-order
        # generation (``decode_layout``) also needs device scoring
        self._layout = None
        if self._fused:
            from ..ops.decode_layout import DecodeLayout

            self._layout = DecodeLayout(self.spec, self.model.options,
                                        pad=self._pad)
        self.decode_layout = (self._layout if self._device_cider is not None
                              else None)

    def _resolve_fused(self, want) -> bool:
        """``resolve_fused`` of this task's model and device."""
        return resolve_fused(self.model.options, want, self.device)

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
        """``decode(lo, hi)`` on row blocks [lo, hi) of at most a launch's
        128 rows (MAX_ROWS), one launch each, its (seq, lp) joined along
        ``axis``.
        Rows are independent but for the batch-wide early exit, which only
        skips steps whose tokens are 0 anyway, so no token changes."""
        outs = [decode(lo, min(lo + MAX_ROWS, B))
                for lo in range(0, B, MAX_ROWS)]
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

    def _decode_fused(self, params: dict, feats, lanes):
        """The kernels' decode of members (params with a leading member
        axis, feats (M, B, F)): greedy kinds K1 (K4 when tiled) once per
        image; the sampling kinds K3, ``seq_per_img`` lanes per member from
        ``lanes`` ((M, spi) uint32 lane seeds, or an (M, spi, T, B, Vpad)
        f32 Gumbel table), and for the self-critical kinds K1 again for the
        greedy baseline. Returns (seq, lp, baseline seq or None): (M, R,
        T), R = B, or B * spi image-major sampled rows."""
        if not self.samples:
            return (*self._greedy(params, feats, self.need_logprobs), None)
        if lanes is None:
            raise ValueError(f"fitness {self.fitness_kind!r} samples: the "
                             "rollout needs its lanes' noise")
        seq, lp = self._sample(params, feats, lanes)  # (M, spi, B, T)
        M, spi, B, T = seq.shape
        # image-major rows b * spi + i
        seq = seq.transpose(1, 2).reshape(M, B * spi, T)
        lp = lp.transpose(1, 2).reshape(M, B * spi, T)
        base = (self._greedy(params, feats)[0]
                if self.fitness_kind in SELF_CRITICAL_KINDS else None)
        return seq, lp, base

    def _eager_gumbel(self, lanes, M: int, B: int):
        """Step t -> (M, B * spi, Vpad) Gumbel values of the eager
        decoder's image-major rows, row b * spi + i from lane i's stream at
        batch row b: drawn from (M, spi) uint32 lane seeds as K3 draws them
        (``gumbel_plain``), or read from an (M, spi, T, B, V) table."""
        spi = self.seq_per_img
        if torch.is_tensor(lanes):
            return lambda t: lanes[:, :, t].transpose(1, 2).reshape(
                M, B * spi, -1)
        seeds = torch.as_tensor(np.asarray(lanes).astype(np.int64),
                                device=self.device)
        Vpad = pad_vocab(self.data.vocab_size + 1)
        return lambda t: gumbel_plain(seeds, t, B, Vpad).transpose(
            1, 2).reshape(M, B * spi, Vpad)

    def _decode_eager(self, thetas, feats, lanes):
        """The eager decode of torch-order members thetas (M, dim), feats
        (M, B, F): ``sample_members`` over each member's whole batch, the
        sampling kinds on its B * spi image-major rows with the noise of
        ``lanes`` (as ``_decode_fused`` takes it) and the self-critical
        baseline greedily on its B rows (JAX: captioning.py:288-289,
        316-318). Returns what ``_decode_fused`` returns."""
        sample = self.model.sample_members
        if not self.samples:
            return (*sample(thetas, feats), None)
        if lanes is None:
            raise ValueError(f"fitness {self.fitness_kind!r} samples: the "
                             "rollout needs its lanes' noise")
        M, B = feats.shape[:2]
        seq, lp = sample(thetas, feats.repeat_interleave(self.seq_per_img, 1),
                         greedy=False, gumbel=self._eager_gumbel(lanes, M, B))
        base = (sample(thetas, feats)[0]
                if self.fitness_kind in SELF_CRITICAL_KINDS else None)
        return seq, lp, base

    def _score(self, seq, lp, base, idx, consts) -> dict:
        """A rollout's artifact: ``{"fitness": (M,)}`` from the device
        scorer, or for host scoring the tokens ``{"seq"}`` in the wire
        dtype, with ``"logprob"`` for the criteria kinds and
        ``"greedy_seq"`` for the self-critical kinds (JAX: captioning.py:
        306-319), which ``host_fitness`` scores."""
        if self._device_cider is not None:
            return {"fitness": self._device_fitness(
                seq, idx, consts.get("cider"), lp=lp, base_seq=base)}
        art = {"seq": seq.to(self._wire_dtype)}
        if self.need_logprobs:
            art["logprob"] = lp
        if base is not None:
            art["greedy_seq"] = base.to(self._wire_dtype)
        return art

    def rollout_dec(self, vec_dec, idx, consts=None, lanes=None):
        """Rollouts of decode-ordered members (the decode layout: fused and
        device-scored), one launch per decode and block of 128 rows:
        vec_dec (M, dim_dec), idx (M, B); ``lanes`` as ``_decode_fused``
        takes them. Returns (M,) fitnesses."""
        consts = self.device_consts() if consts is None else consts
        seq, lp, base = self._decode_fused(
            self.decode_layout.prep(vec_dec, self._decode_dtype),
            consts["train_fc"][idx], lanes)
        return self._device_fitness(seq, idx, consts.get("cider"), lp=lp,
                                    base_seq=base)

    def rollout(self, thetas, idx, consts=None, lanes=None) -> dict:
        """Rollouts of torch-order members (JAX: captioning.py:291-319):
        thetas (M, dim) flat f32; idx (B,), one batch shared by every member
        (NIC-ES), or (M, B), each member's own (NIC-NES pairs); ``lanes``
        the sampling kinds' noise per member. Fused, the members are laid
        out in decode order by the exact ``to_dec`` and decoded by the
        kernels; eager, by ``sample_members``. Returns ``_score``'s
        artifact: ``{"fitness": (M,)}`` or the host scorer's tokens."""
        consts = self.device_consts() if consts is None else consts
        idx = torch.as_tensor(idx, device=self.device)
        if idx.dim() == 1:
            idx = idx.reshape(1, -1).expand(thetas.shape[0], -1)
        feats = consts["train_fc"][idx]
        if self._fused:
            lay = self._layout
            decoded = self._decode_fused(
                lay.prep(lay.to_dec(thetas), self._decode_dtype), feats, lanes)
        else:
            decoded = self._decode_eager(thetas, feats, lanes)
        return self._score(*decoded, idx, consts)

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

    # ---- host fitness ---------------------------------------------------------------

    def _score_dedup(self, cands: np.ndarray, img_idx: np.ndarray
                     ) -> np.ndarray:
        """CIDEr-D of each row (cands (N, T), img_idx (N,)), each distinct
        (caption, image) scored once and scattered back: nearby thetas
        often decode the same caption for an image (JAX: captioning.py:
        502-526). The key is a 64-bit multiplicative hash of the row's
        tokens and image; with 90% or more of the rows distinct every row
        is scored, skipping the indirection."""
        key = np.concatenate([np.ascontiguousarray(cands, np.int64),
                              img_idx[:, None].astype(np.int64)], axis=1)
        mult = np.array([(0x9E3779B97F4A7C15 * (i + 1)) % (1 << 64)
                         for i in range(key.shape[1])],
                        dtype=np.uint64).view(np.int64)
        with np.errstate(over="ignore"):
            hashes = (key * mult).sum(axis=1)
        _, first, inverse = np.unique(hashes, return_index=True,
                                      return_inverse=True)
        self.dedup_rows = (len(first), len(hashes))
        if len(first) >= 0.9 * len(hashes):
            return self.train_scorer.score(cands, img_idx)[1]
        return self.train_scorer.score(cands[first],
                                       img_idx[first])[1][inverse.ravel()]

    def host_fitness(self, artifacts, idx) -> np.ndarray:
        """The fitnesses of a sweep's artifacts with leading member axes:
        the device scorer's pass through; token artifacts are scored here,
        every row of every member in one ``_score_dedup`` on the native
        scorer, then reduced per member (JAX: captioning.py:528-573). idx:
        (B,), the batch of every member (NIC-ES), or (F, B) for NES's (F,
        2) pairs, whose two members share row m // 2. The self-critical
        kinds subtract each image's greedy-baseline CIDEr-D from its
        samples; the criteria kinds reduce on the host (``apply_criterion``,
        f64)."""
        if "fitness" in artifacts:
            return super().host_fitness(artifacts, idx)
        host = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in artifacts.items()}
        seq = host["seq"]
        lead = seq.shape[:-2]
        n = int(np.prod(lead))
        R, T = seq.shape[-2:]
        seq_f = seq.reshape(n, R, T)
        idx = np.asarray(idx)
        if idx.ndim == 1:
            rows = np.broadcast_to(idx, (n, idx.shape[0]))
        else:
            rows = np.repeat(idx, int(np.prod(lead[1:])), axis=0)
        B = rows.shape[1]
        spi = R // B
        img_idx = np.repeat(rows, spi, axis=1)  # (n, R)
        scores = self._score_dedup(seq_f.reshape(-1, T),
                                   img_idx.reshape(-1)).reshape(n, R)
        if self.fitness_kind in SELF_CRITICAL_KINDS:
            base = self.train_scorer.score(
                host["greedy_seq"].reshape(-1, T), rows.reshape(-1))[1]
            scores = scores - np.repeat(base.reshape(n, B), spi, axis=1)
        if self.need_logprobs:
            lp = host["logprob"].reshape(n, R, T)
            out = np.asarray([
                apply_criterion(self.fitness_kind, lp[m], seq_f[m],
                                np.repeat(scores[m][:, None], T, axis=1))
                for m in range(n)], dtype=np.float32)
        else:
            out = (scores.mean(axis=1) * 100.0).astype(np.float32)
        return out.reshape(lead)

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
        """Greedy tokens (N, T) of theta on feats (N, F): ``greedy_rows`` at
        the task's precision, the eager chunks of ``val_batch_size`` (else
        ``batch_size``, else 64)."""
        return greedy_rows(
            self.model, theta, feats, self._fused, self._decode_dtype,
            self.config.val_batch_size or self.config.batch_size or 64,
            vocab_tile=self._vocab_tile, pad=self._pad)

    def _decode_split(self, theta, feats, num: int) -> np.ndarray:
        """Greedy tokens of the first ``num`` rows of a split (all for -1,
        0 or None), as ``_decode_rows`` decodes them."""
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
        JAX package)."""
        seqs = self._decode_split(theta, self.val_fc,
                                  self.config.num_val_items or -1)
        self._write_predictions(seqs, "val")
        mean, _ = self.val_scorer.score(self.data.word_id_rows(seqs),
                                        np.arange(len(seqs)))
        return float(mean)

    def test_score(self, theta) -> float:
        """Word-level plain CIDEr of theta's greedy captions over the whole
        test split, decoded as ``_decode_rows`` decodes (fused: one
        row-block launch at the task's precision) and scored on the host
        by the native scorer; writes ``eval_cache_test.json`` (JAX:
        captioning.py:726-735)."""
        seqs = self._decode_split(theta, self.test_fc, -1)
        self._write_predictions(seqs, "test")
        scorer = IndexedCiderScorer(self.data.split_gts_words("test"),
                                    variant="cider")
        mean, _ = scorer.score(self.data.word_id_rows(seqs),
                               np.arange(len(seqs)))
        return float(mean)

    def device_val_consts(self) -> dict | None:
        """The card's constants of ``validate_device``, built once: the val
        subset's feats (fused: in the decode dtype at the data's width,
        which the row-block launch zero-pads to the kernels'; eager: f32, chunked by
        ``_decode_rows``), the token -> word-id
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
                "feats": (self.val_fc[:n].to(self._decode_dtype).contiguous()
                          if self._fused else self.val_fc[:n]),
                "word": torch.as_tensor(table, dtype=torch.int64,
                                        device=self.device),
                "img": torch.arange(n, device=self.device),
                "cider": self._val_device_cider.dev,
            }
        return self._val_dev_cache

    def validate_device(self, theta, vconsts) -> torch.Tensor:
        """validate() on the card: the val subset decoded as
        ``_decode_rows`` decodes it, the word-id gather and the word-level plain CIDEr of DeviceCider;
        the mean score as a 0-d f32 tensor on the card, with no host sync
        and no predictions JSON (JAX: captioning.py:696-724). Equal to
        validate() to f32 accuracy."""
        seqs = self._decode_rows(theta, vconsts["feats"])
        wids = vconsts["word"][seqs.clamp(0, self.data.vocab_size).long()]
        return self._val_device_cider.score_rows(
            wids, vconsts["img"], dev=vconsts["cider"]).mean()
