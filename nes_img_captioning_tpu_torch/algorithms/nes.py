"""NIC-NES (port of ``nes_img_captioning_tpu/algorithms/nes.py``): the
``NESEngine`` of one generation and the ``NESMaster`` training loop.

One generation, in the decode-ordered parameter layout (ops/decode_layout.py):

1. each antithetic pair gets ``delta = dt(scale_dec * N(0, 1))`` drawn from
   its seed and rounded once to the storage dtype (``tpu.delta_dtype``);
2. the pair kernel (K2, ``tpu.kernel_perturb``; greedy kinds, untiled)
   decodes both rollouts of every pair of a chunk in one launch, or the
   per-member path decodes the chunk's 2 x chunk members ``base ± delta``
   in one launch: greedily with K1 (K4 with ``tpu.decode_vocab_tile``), or,
   for the sampling kinds, ``seq_per_img`` lanes per member with K3, each
   member (seed, sign) drawing its lanes' noise from ``gumbel_of``, plus a
   greedy baseline decode for the self-critical kinds;
3. CIDEr-D scores every decoded row on the device (the criteria kinds
   reduce the scores and logprobs to a per-token criterion);
4. centered ranks give the pair weights (pad lanes weight 0);
5. the gradient sum_i w_i * delta_i is rebuilt from deltas drawn again from
   the seeds, summed over the pairs in order, and mapped back with
   ``from_dec``;
6. the optimizer steps, and ``[fitness | ratio | mean|theta|]`` is packed.

With ``tpu.kernel_noise`` on (it rides on the pair kernel), steps 1, 2 and 5
draw no noise outside the kernels: K5 (``decode_pair_rng``) makes each
pair's f32 delta in the kernel from its seed, once per chunk, and K6
(``pair_grad_rng_flat``, on the flat decode-ordered scale) draws the same
deltas again and sums the weighted gradient, once per generation (JAX:
``nes.py:356-403``).

A device-scored task without a decode layout (``MnistTask``; the
captioner decoded eagerly) runs the same generation in torch order (JAX:
``nes.py:328-331``): each pair's delta ``scale * N(0, 1)`` over the flat
theta in f32 (``normal_of``; ``tpu.delta_dtype`` is the layout path's), the
chunk's pair-major members ``base ± delta`` scored by one ``task.rollout``,
and no ``from_dec``; the pair kernel and in-kernel noise resolve off.

A host-scored task (the captioner with ``tpu.device_cider`` off, or a
vocabulary too large for the device scorer) splits the generation as the
JAX package does (``nes.py:616-650``): ``eval_generation`` rolls out the
torch-order members and returns their token artifacts with leading (F, 2)
axes, and the deltas while all of them fit ``DELTA_BYTES_LIMIT``; the
master scores them (``task.host_fitness``) and ``update`` steps with the
carried deltas, or draws them again from the seeds: the same sum in the
same order, so both give the same bits.

Safe mutations scale the noise by ``sigma / sens``: SM-VECTOR's vector, or
for SM-G-SUM and SM-G-ABS the sensitivity of the generation's own theta
over the first ``tpu.sensitivity_batch`` rows of member 0's batch
(``ops/sensitivity.calc_sensitivity``). With ``inline_sens`` (on for SM-G)
each generation computes it from its theta, so a block of generations stays
exact (JAX: ``nes.py:277-300``); otherwise the master computes it once per
dispatch (``NESMaster._maybe_sensitivity``) and SM-G runs one generation
per dispatch.

``generation_val_block`` (``tpu.fused_validation``) runs K generations
with the validation on the card: each first validates its pre-update theta
(``CocoTask.validate_device``) and merges it into the device podium
(``es.podium_merge``), with no host sync until the block's rows are read.

Under a process group (``tpu.mesh_shape``, ``parallel/``) every rank
draws the same seeds and batches and rolls out its contiguous shard of the
pairs; the fitnesses are gathered, every rank computes the same
centered-rank weights, and each rank's lanes give a partial gradient (K6
over its lanes, or the delta operands' ordered sum) summed over the ranks
in rank order. The fitnesses are bitwise one process's; the gradient is
one process's sum in another order (its rank-order sum of partial sums),
so theta agrees within that rounding, and is the same on every rank.

The eval paths feed the fitness scorer the same tensors laid out the same
way, and every gradient sums ``w_i * delta_i`` in pair order with each
product rounded to f32 first (K6's order), so with equal tokens and equal
deltas their packed vectors are bitwise equal.
Reference math: src/algorithm/nic_nes/nic_nes_master.py:123-133,170-182.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .engine_base import PopulationEngine
from .es import podium_merge
from .experiment import NESExperiment
from .master_base import MasterBase, setup_log_dir
from .snapshot import save_snapshot
from ..ops.mutation import MutationKind, normal_from_seed, shape_noise
from ..ops.noise import lane_seeds
from ..ops.ranks import compute_centered_ranks
from ..ops.sensitivity import calc_sensitivity, subsample_batch_rows
from ..utils.files import mkdir_p, remove_all_files_from_dir

logger = logging.getLogger(__name__)

__all__ = ["NESEngine", "NESMaster", "setup_log_dir"]


class NESEngine(PopulationEngine):
    """Device-side math for NES generations: one card, or this rank's
    shard of the pairs under a process group (``mesh``)."""

    # eval_generation hands its deltas to update while the (F, dim) f32
    # matrix fits (JAX: nes.py:176)
    DELTA_BYTES_LIMIT = 4 << 30

    def __init__(self, task, optimizer, mutation: MutationKind,
                 pop_chunk: int = 0, kernel_perturb: object = "auto",
                 kernel_noise: object = "auto", delta_dtype: str = "f32",
                 sens_batch: int = 0, inline_sens: bool | None = None,
                 mesh=None, **sens):
        """``mesh``: this rank's ``RankGroup`` (None: one process);
        ``sens``: the SM-G settings of ``PopulationEngine``;
        ``sens_batch``: the sweep's batch rows (``tpu.sensitivity_batch``).
        ``inline_sens``: each generation computes its SM-G sensitivity from
        its own theta; None (auto) turns it on for SM-G on a device-scored
        task, as the JAX package does (nes.py:76-104); a host-scored task's
        master computes it (``NESMaster._maybe_sensitivity``)."""
        super().__init__(task, pop_chunk=pop_chunk, mutation=mutation,
                         mesh=mesh, **sens)
        self.optimizer = optimizer
        self.inline_sens = (mutation.is_gradient and task.fitness_on_device
                            if inline_sens is None else bool(inline_sens))
        if self.inline_sens and not (mutation.is_gradient
                                     and task.fitness_on_device):
            raise ValueError(
                f"inline_sens=True requires an SM-G-* mutation and a "
                f"device-scored task, not {mutation.value or 'the default'}"
                f" with fitness_on_device={task.fitness_on_device}")
        self._sens_batch = int(sens_batch)
        self._layout = (getattr(task, "decode_layout", None)
                        if task.fitness_on_device else None)
        # "auto" and True both take the pair kernel where the task has it
        pair_ok = getattr(task, "supports_pair_perturb", False)
        self._kernel_perturb = kernel_perturb is not False and pair_ok
        if kernel_perturb is True and not pair_ok:
            logger.warning(
                "tpu.kernel_perturb=true but the task does not support the "
                "pair kernel (needs fused decode, device scoring, a greedy "
                "fitness kind and untiled logits); using the per-member path")
        if delta_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"delta_dtype={delta_dtype!r}: expected 'f32' or 'bf16'")
        self._delta_dtype = (torch.bfloat16 if delta_dtype == "bf16"
                             else torch.float32)
        # in-kernel noise: "auto" resolves off, as in the JAX package
        # (nes.py:163-164); true needs the pair kernel active
        noise_ok = (self._kernel_perturb
                    and getattr(task, "supports_kernel_noise", False))
        self._kernel_noise = kernel_noise is True and noise_ok
        if kernel_noise is True and not noise_ok:
            logger.warning(
                "tpu.kernel_noise=true but the pair kernel is not active "
                "here (tpu.kernel_perturb=false, or the task lacks it); "
                "using delta operands")

    # ---- math ----------------------------------------------------------------------

    def sensitivity(self, theta, idx_row, seed0: int) -> torch.Tensor:
        """The post-processed SM-G sensitivity (dim,) of ``theta`` over the
        first ``sens_batch`` rows of the host batch ``idx_row``, with the
        probes of ``probes_of(seed0, ...)`` when ``sens_probes`` is set
        (JAX: _traced_sens). Host operands reach the card through pinned
        memory: no host sync."""
        idx_d, probes = self._sens_operands(
            subsample_batch_rows(idx_row, self._sens_batch), seed0,
            theta.device)
        return calc_sensitivity(self.task, theta, idx_d, self.mutation,
                                self._sens_underflow, self._sens_precision,
                                probes)

    def _scale_vec(self, theta, sens, sigma):
        """Member-independent noise scale: delta == scale_vec * N(0, 1) for
        every mutation kind this engine takes."""
        return shape_noise(
            torch.full_like(theta, float(sigma)), theta,
            sensitivity=sens if self.mutation.is_safe else None,
            proportional=self.mutation.is_proportional)

    def normal_of(self, seed: int) -> torch.Tensor:
        """The N(0, 1) noise of pair ``seed``, f32 on the task's device:
        (dim_dec,) in decode order on the layout path, (dim,) in torch order
        without one. Tests replace this with the JAX package's realized
        noise."""
        n = self.dim if self._layout is None else self._layout.dim_dec
        return normal_from_seed(seed, n, self.task.device)

    def delta_of(self, scale_dec: torch.Tensor, seed: int) -> torch.Tensor:
        """The pair's delta ``scale * N(0, 1)``; on the layout path in
        decode order and rounded once to the storage dtype
        (``tpu.delta_dtype``), in torch order f32. Eval and gradient both
        consume this value."""
        delta = scale_dec * self.normal_of(seed)
        return delta if self._layout is None else delta.to(self._delta_dtype)

    def _deltas(self, scale_dec, seeds_c) -> torch.Tensor:
        return torch.stack([self.delta_of(scale_dec, int(s)) for s in seeds_c])

    def gumbel_of(self, seeds: np.ndarray, sign: int):
        """The sampling noise of the members (seed, sign) for each pair seed
        of ``seeds`` and sign +1 or -1: their (N, seq_per_img) uint32 lane
        seeds, from which K3 draws the Gumbel values in the kernel (the JAX
        package's per-member keys ``fold_in(key(seed), 1 or 2)``, nes.py:
        377-383). Tests replace this with a function that returns (N,
        seq_per_img, T, B, Vpad) f32 tables instead, which the rollouts read
        through K3's host-table form."""
        return lane_seeds(seeds, np.full(len(seeds), sign),
                          self.task.seq_per_img)

    def _lanes(self, seeds_c):
        """The pair-major members' sampling noise: rows 2i and 2i+1 are
        (seed_i, +1) and (seed_i, -1)."""
        pos, neg = self.gumbel_of(seeds_c, 1), self.gumbel_of(seeds_c, -1)
        if torch.is_tensor(pos):
            return torch.stack([pos, neg], 1).flatten(0, 1)
        return np.stack([pos, neg], 1).reshape(2 * len(seeds_c), -1)

    def _rollout_members(self, base_vec, deltas, idx_c, seeds_c, consts
                         ) -> dict:
        """One chunk's pair-major members ``base ± delta`` (row 2i is
        +delta_i, row 2i+1 -delta_i) rolled out in one call, the sampling
        kinds with their lanes' noise: ``task.rollout_dec`` on the layout
        path, ``task.rollout`` in torch order. Returns the task's artifact
        with a leading 2 * chunk axis."""
        task = self.task
        members = torch.stack([base_vec + deltas, base_vec - deltas],
                              1).reshape(2 * deltas.shape[0], -1)
        idx2 = idx_c.repeat_interleave(2, 0)
        lanes = (self._lanes(seeds_c) if getattr(task, "samples", False)
                 else None)
        if self._layout is None:
            return task.rollout(members, idx2, consts=consts, lanes=lanes)
        return {"fitness": task.rollout_dec(members, idx2, consts=consts,
                                            lanes=lanes)}

    @staticmethod
    def _accumulate(grad, w_c, deltas_c):
        """grad + sum_i w_i * delta_i over one chunk, in pair order, each
        product rounded to f32 before it is added: the order of K6
        (pair_grad_rng), so both noise paths give the same gradient bits."""
        for w, d in zip(w_c, deltas_c):
            grad = grad + w * d.to(torch.float32)
        return grad

    def _apply_grad(self, theta, opt_state, grad, fitness_count, stepsize,
                    l2coeff):
        """reference math: nic_nes_master.py:123-133,170-182."""
        globalg = -(grad / fitness_count) + l2coeff * theta
        return self.optimizer.step(opt_state, theta, globalg, stepsize)

    @staticmethod
    def _pair_weights(fitnesses, lanes_shape, plan=None):
        """Per-pair weights from the (F, 2) fitnesses of all the pairs, the
        rank's of ``plan`` (pads 0), zero-padded to the (n_chunks, chunk)
        lane layout of its sweep (pad lanes repeat a real seed)."""
        ranked = compute_centered_ranks(fitnesses)
        w = ranked[:, 0] - ranked[:, 1]
        if plan is not None:
            w = plan.local_weights(w)
        n_lanes = lanes_shape[0] * lanes_shape[1]
        w = torch.nn.functional.pad(w, (0, n_lanes - w.shape[0]))
        return w.reshape(lanes_shape)

    # ---- host entry points ----------------------------------------------------------

    def generation(self, theta, opt_state, sens, sigma, seeds: np.ndarray,
                   idx: np.ndarray, stepsize: float, l2coeff: float):
        """One generation. seeds (F,) uint32, idx (F, B) int rows of the
        training set; ``sens`` the safe kinds' (dim,) sensitivity, replaced
        with ``inline_sens`` by that of theta over member 0's batch.
        Returns (theta, opt_state, packed) with packed = [fitnesses (2F) |
        ratio | mean|theta|] on theta's device. A device-scored task's
        generation; a host-scored one runs ``eval_generation`` and
        ``update``. Under a group the rank rolls out its shard of the pairs,
        the fitnesses are gathered, and its lanes' partial gradient (K6, or
        the delta operands' sum) is summed over the ranks in rank order:
        the same theta on every rank, within the sum order's rounding of one
        process's (JAX: a psum of partial sums, nes.py:18-21)."""
        task, lay = self.task, self._layout
        if not task.fitness_on_device:
            raise ValueError("a host-scored task's generation is "
                             "eval_generation, host_fitness, then update")
        if self.inline_sens:
            sens = self.sensitivity(theta, idx[0], seeds[0])
        plan = self._shard(seeds.shape[0])
        n_chunks, chunk, seeds_l, idx_l = self._chunked(
            plan.local(seeds), plan.local(idx), theta.device)
        consts = task.device_consts()

        scale = self._scale_vec(theta, sens, sigma)
        if lay is None:
            # torch order (JAX: nes.py:328-331): the members are flat
            # thetas and the task scores them itself
            base_vec, scale_dec, from_dec = theta, scale, (lambda g: g)
        else:
            base_vec, from_dec = lay.to_dec(theta), lay.from_dec
            scale_dec = lay.to_dec(scale, pad_scale=0.0)
        if self._kernel_perturb:
            base_params = task.pair_base_params(base_vec)
        if self._kernel_noise:
            scale_params = task.pair_base_params(scale_dec)
        fits = []
        for c in range(n_chunks):
            if self._kernel_noise:
                fits.append(task.rollout_pair_rng(base_params, scale_params,
                                                  seeds_l[c], idx_l[c],
                                                  consts=consts))
                continue
            deltas = self._deltas(scale_dec, seeds_l[c])
            if self._kernel_perturb:
                fits.append(task.rollout_pair_dec(base_params, deltas,
                                                  idx_l[c], consts=consts))
            else:
                fits.append(self._rollout_members(
                    base_vec, deltas, idx_l[c], seeds_l[c],
                    consts)["fitness"].reshape(chunk, 2))
        fitnesses = self._gather(
            torch.cat(fits).reshape(-1, 2)[:plan.per_rank], plan)

        weights = self._pair_weights(fitnesses, seeds_l.shape, plan)
        if self._kernel_noise:
            from ..ops.decode_cuda import pair_grad_rng_flat

            grad = pair_grad_rng_flat(scale_dec, seeds_l.reshape(-1),
                                      weights.reshape(-1))
        else:
            grad = torch.zeros_like(scale_dec)
            for c in range(n_chunks):
                grad = self._accumulate(grad, weights[c],
                                        self._deltas(scale_dec, seeds_l[c]))
        opt_state, theta, ratio = self._apply_grad(
            theta, opt_state, from_dec(self._reduce(grad)),
            fitnesses.numel(), stepsize, l2coeff)
        packed = torch.cat([fitnesses.reshape(-1), ratio.reshape(1),
                            theta.abs().mean().reshape(1)])
        return theta, opt_state, packed

    def generation_block(self, theta, opt_state, sens, sigma,
                         seeds: np.ndarray, idx: np.ndarray, stepsize: float,
                         l2coeff: float):
        """K generations in sequence. seeds (K, F), idx (K, F, B); returns
        (theta, opt_state, packs (K, 2F+2))."""
        packs = []
        for k in range(seeds.shape[0]):
            theta, opt_state, packed = self.generation(
                theta, opt_state, sens, sigma, seeds[k], idx[k], stepsize,
                l2coeff)
            packs.append(packed)
        return theta, opt_state, torch.stack(packs)

    def generation_val_block(self, theta, opt_state, sens, sigma,
                             seeds: np.ndarray, idx: np.ndarray,
                             stepsize: float, l2coeff: float, e_rows,
                             e_scores: np.ndarray):
        """K generations with validation on the card (tpu.fused_validation):
        each validates its pre-update theta (``task.validate_device``, one
        validation per generation as the reference's nic_nes/iteration.py:
        49-50), merges it into the (E, dim) device podium ``e_rows`` (slot
        scores ``e_scores``, -inf where unfilled) with ``podium_merge``, then
        runs the generation. seeds (K, F), idx (K, F, B). Returns (theta,
        opt_state, e_rows, rows (K, 2F+3+E)), each row [fitnesses (2F) |
        ratio | mean|theta| | val | elite scores (E)], all on the card (JAX:
        nes.py:448-488)."""
        vconsts = self.task.device_val_consts()
        e_scores = torch.as_tensor(np.asarray(e_scores, np.float32),
                                   device=theta.device)
        rows = []
        for k in range(seeds.shape[0]):
            val = self.task.validate_device(theta, vconsts).reshape(1)
            if e_rows.shape[0]:
                e_rows, e_scores = podium_merge(e_rows, e_scores, theta[None],
                                                val)
            theta, opt_state, packed = self.generation(
                theta, opt_state, sens, sigma, seeds[k], idx[k], stepsize,
                l2coeff)
            rows.append(torch.cat([packed, val, e_scores]))
        return theta, opt_state, e_rows, torch.stack(rows)

    def _chunked(self, seeds, idx, device):
        """(n_chunks, chunk, seeds (n_chunks, chunk) uint32, idx rows
        (n_chunks, chunk, B) on ``device``), padded with the last pair."""
        n_chunks, chunk = self._plan(seeds.shape[0])
        seeds_l = self._lay_out(np.asarray(seeds, np.uint32), n_chunks, chunk)
        if idx is None:
            return n_chunks, chunk, seeds_l, None
        return n_chunks, chunk, seeds_l, torch.as_tensor(
            self._lay_out(np.asarray(idx, np.int64), n_chunks, chunk),
            device=device)

    def eval_generation(self, theta, sens, sigma, seeds: np.ndarray,
                        idx: np.ndarray):
        """The rollouts of a host-scored generation (JAX: nes.py:616-631):
        seeds (F,), idx (F, B) -> (artifacts with leading (F, 2) axes,
        [pos, neg] per pair; the deltas (n_chunks, chunk, dim) f32 in torch
        order, or None when they exceed ``DELTA_BYTES_LIMIT``). Each pair's
        delta is ``scale * N(0, 1)`` of ``normal_of``; pass the deltas to
        ``update`` to skip drawing them again. Under a group, both are the
        rank's shard's (``ShardPlan.per_rank`` pairs; ``host_fitness``
        gathers the fitnesses). The decode-layout path (fused decode, device
        scoring) runs ``generation`` instead."""
        if self._layout is not None:
            raise ValueError("eval_generation rolls out torch-order members;"
                             " the decode-layout path runs generation")
        plan = self._shard(seeds.shape[0])
        n_chunks, chunk, seeds_l, idx_l = self._chunked(
            plan.local(seeds), plan.local(idx), theta.device)
        carry = n_chunks * chunk * self.dim * 4 <= self.DELTA_BYTES_LIMIT
        consts = self.task.device_consts()
        scale = self._scale_vec(theta, sens, sigma)
        arts, kept = [], []
        for c in range(n_chunks):
            deltas = self._deltas(scale, seeds_l[c])
            if carry:
                kept.append(deltas)
            arts.append(self._rollout_members(theta, deltas, idx_l[c],
                                              seeds_l[c], consts))
        n = plan.per_rank
        art = {k: torch.cat([a[k] for a in arts])[:2 * n].reshape(
            n, 2, *arts[0][k].shape[1:]) for k in arts[0]}
        return art, (torch.stack(kept) if carry else None)

    def update(self, theta, opt_state, sens, sigma, seeds: np.ndarray,
               fitnesses, stepsize: float, l2coeff: float, deltas=None):
        """The step of a host-scored generation from its (F, 2) fitnesses
        (JAX: nes.py:633-650): the centered-rank weights, the gradient
        summed over the pairs in order (``_accumulate``, K6's order) from
        eval_generation's ``deltas``, or from deltas drawn again from the
        seeds (the same bits), then the optimizer. Under a group
        ``fitnesses`` are all the pairs', ``deltas`` the rank's shard's, and
        the partial sums are summed over the ranks. Returns (opt_state,
        theta, ratio)."""
        plan = self._shard(seeds.shape[0])
        n_chunks, chunk, seeds_l, _ = self._chunked(plan.local(seeds), None,
                                                    None)
        fitnesses = torch.as_tensor(np.asarray(fitnesses, np.float32),
                                    device=theta.device)
        weights = self._pair_weights(fitnesses, (n_chunks, chunk), plan)
        if deltas is None:
            scale = self._scale_vec(theta, sens, sigma)
        grad = torch.zeros_like(theta)
        for c in range(n_chunks):
            grad = self._accumulate(
                grad, weights[c], deltas[c] if deltas is not None
                else self._deltas(scale, seeds_l[c]))
        return self._apply_grad(theta, opt_state, self._reduce(grad),
                                fitnesses.numel(), stepsize, l2coeff)

    @staticmethod
    def unpack_val(rows, F: int, E: int):
        """(fitnesses (K, F, 2), ratio (K,), mean|theta| (K,), val (K,),
        elite scores after each merge (K, E)) as numpy from
        generation_val_block's rows: the block's one host sync."""
        arr = rows.detach().cpu().numpy()
        off = 2 * F
        fits = arr[..., :off].reshape(*arr.shape[:-1], F, 2)
        return (fits, arr[..., off], arr[..., off + 1], arr[..., off + 2],
                arr[..., off + 3:off + 3 + E])

    @staticmethod
    def unpack(packed, F: int):
        """(fitnesses (F, 2), ratio, mean|theta|) as numpy; accepts a (2F+2,)
        vector or a (K, 2F+2) block."""
        arr = packed.detach().cpu().numpy() if torch.is_tensor(packed) \
            else np.asarray(packed)
        fits = arr[..., :-2].reshape(*arr.shape[:-1], F, 2)
        return fits, arr[..., -2], arr[..., -1]


class NESMaster(MasterBase):
    """The training loop (port of ``NESMaster`` in
    ``nes_img_captioning_tpu/algorithms/nes.py``): owns theta and the
    optimizer state on the device and all host-side bookkeeping (iteration,
    statistics, podium, snapshots). One process on one card.

    A resumed run continues the seeds as well as the batches
    (``MasterBase``): N generations, or N/2 then a resume and N/2 more,
    give the same theta.

    With ``tpu.fused_validation`` (on under "auto" when the run can fuse it
    and ``gens_per_dispatch`` > 1, as in the JAX package) every generation of
    a block validates on the card and the podium's rows stay there: the
    block's rows are read once at its end, and the slot files are written
    when something reads them (``_materialize_podium``).

    Safe mutations: SM-VECTOR loads its vector at start; SM-G computes its
    sensitivity in each generation (the engine's ``inline_sens``), or with
    it off once per dispatch here (``_maybe_sensitivity``), one generation
    per dispatch then.

    ``tpu.profile`` traces the dispatch that runs generation 2 into
    ``<log_dir>/profile/`` (``MasterBase._profile_hook``). Under a process
    group every rank runs this loop on the same draws and the engine
    shards the pairs (``NESEngine.generation``)."""

    def __init__(self, exp: dict, device=None, data=None, mesh=None):
        """``device``, ``data`` and ``mesh`` as ``MasterBase`` takes
        them."""
        super().__init__(exp, device=device, data=data, mesh=mesh)
        tpu = self.tpu_cfg
        self.experiment = NESExperiment(exp, self.config, self.task)
        self.optimizer = self.experiment.optimizer
        self.engine = NESEngine(
            self.task, self.optimizer, self.mutation,
            pop_chunk=tpu.pop_chunk, mesh=self.mesh,
            kernel_perturb=tpu.kernel_perturb,
            kernel_noise=tpu.kernel_noise, delta_dtype=tpu.delta_dtype,
            sens_underflow=self._underflow,
            sens_precision=tpu.sensitivity_precision,
            sens_batch=tpu.sensitivity_batch,
            sens_probes=tpu.sensitivity_probes)

        self._current_dir = mkdir_p(
            os.path.join(self.it.models_dir(), "current"))
        self._current_path = os.path.join(self._current_dir,
                                          "0_current_params.pth")
        self._last_eval = None
        self._val_fused = False  # resolved by run_master
        self._init_theta(exp)
        self.opt_state = (self.experiment.opt_state
                          or self.optimizer.init(self.engine.dim, self.device))
        self.experiment.opt_state = self.opt_state
        # the safe kinds' sensitivity: SM-VECTOR's vector; SM-G's of the
        # last host-computed generation (inline, each generation's own)
        self._sens = (self._sens_vector if self._sens_vector is not None
                      else torch.ones(self.engine.dim, dtype=torch.float32,
                                      device=self.device))

    # ---- init modes (reference: tools/setup.py:33-44) -----------------------

    def _init_theta(self, exp):
        spec = self.task.spec
        if exp.get("from_infos"):
            infos = self._resume(exp["from_infos"])
            theta = spec.load_pth(infos["current_model"])
        elif exp.get("from_single"):
            theta = spec.load_pth(exp["from_single"])
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                int(self._rng.integers(0, 2**31 - 1)))
            theta = self.task.generate_theta(gen)
        self.theta = theta.to(self.device, torch.float32)
        self._write_current_model()

    def _write_current_model(self):
        remove_all_files_from_dir(self._current_dir)
        self.task.spec.save_pth(self.theta, self._current_path)
        # NES checkpoint state (reference: nic_nes/iteration.py:37-41)
        self.it.extra_state = {"current_model": self._current_path}

    def _podium_would_take(self, score: float) -> bool:
        """Would record_elites copy the current model file? (strict >: ties
        keep incumbents.)"""
        return any((not path) or score > sc
                   for path, sc in self.it.best_elites())

    def current_model(self) -> str:
        return self._current_path

    # ---- per-generation pieces ----------------------------------------------

    def _pair_count(self) -> int:
        """``nb_offspring`` antithetic PAIRS = 2 * nb_offspring rollouts per
        generation (reference: nic_nes_worker.py:142-161,
        tools/iteration.py:110-112)."""
        return max(self.exp["nb_offspring"], 1)

    def _maybe_sensitivity(self, idx_row: np.ndarray, seed0) -> torch.Tensor:
        """The ``sens`` operand of the next dispatch (JAX: nes.py:855-889):
        SM-G without ``inline_sens`` computes it here from the current
        theta over member 0's batch ``idx_row``, probes from the member-0
        seed ``seed0``, with the engine's own function (so both paths give
        the same bits); with ``inline_sens`` the generations compute their
        own and this operand is unused."""
        if self.mutation.is_gradient and not self.engine.inline_sens:
            self._sens = self.engine.sensitivity(self.theta, idx_row, seed0)
        return self._sens

    def set_sensitivity_vector(self, vector, underflow: float):
        """SM-VECTOR: a precomputed sensitivity, clamped then min-normalized
        (reference: src/algorithm/safe_mutations.py:28-32)."""
        self._sens = self._place_sens(vector, underflow)

    def _draw_batches(self, F: int, bs: int) -> np.ndarray:
        sampler = self._batch_sampler()
        if self.config.single_batch:
            return np.tile(sampler.batch(bs), (F, 1))
        return sampler.member_batches(F, bs)

    # ---- tpu.fused_validation: validation and podium on the card ------------

    def _val_fused_mode(self) -> bool:
        """Whether the blocks validate on the card (JAX: nes.py:902-925).
        Capable: device fitness, val_freq 1, patience 0 (patience could
        anneal sigma inside a block) and device val consts. "auto" turns it
        on when capable and gens_per_dispatch > 1; true when capable, with a
        warning when not. The device val consts are built last, only when
        the answer depends on them."""
        want = self.tpu_cfg.fused_validation
        if want is False or (want == "auto"
                             and self.tpu_cfg.gens_per_dispatch <= 1):
            return False
        capable = (self.task.fitness_on_device
                   and max(self.tpu_cfg.val_freq, 1) == 1
                   and not self.config.patience
                   and self.task.device_val_consts() is not None)
        if want == "auto":
            return capable
        if not capable:
            logger.warning(
                "tpu.fused_validation=true but this run cannot fuse "
                "validation (needs device fitness, val_freq=1, patience=0); "
                "using host validation")
        return capable

    def _elite_rows_dev(self) -> torch.Tensor:
        """The device podium's (E, dim) rows, built from the slot files on
        first use; unfilled slots are zero rows whose -inf scores keep them
        out of every merge."""
        if self._elites_dev is None:
            elites = self.it.best_elites()
            rows = torch.zeros((len(elites), self.engine.dim),
                               dtype=torch.float32)
            for r, (path, _) in enumerate(elites):
                if path and os.path.isfile(path):
                    rows[r] = self.task.spec.load_pth(path)
            self._elites_dev = rows.to(self.device)
        return self._elites_dev

    def _elite_scores_f32(self) -> np.ndarray:
        return np.asarray([float(np.float32(s)) if p else -np.inf
                           for p, s in self.it.best_elites()], np.float32)

    def _val_fused_step(self, b: int, t_block: float, sigma, seeds, idx,
                        sens, F: int, plot: bool):
        """``b`` generations with validation and podium merge on the card,
        then the host bookkeeping of each from the block's rows, read in one
        sync. The merged scores are adopted at once; the rows stay on the
        card until _materialize_podium (JAX: nes.py:964-1011)."""
        it = self.it
        E = len(it.best_elites())
        new_theta, new_opt_state, e_rows, rows = \
            self.engine.generation_val_block(
                self.theta, self.opt_state, sens, sigma, seeds, idx,
                self.optimizer.stepsize, self.config.l2coeff or 0.0,
                self._elite_rows_dev(), self._elite_scores_f32())
        fits_all, ratios, norms, vals, etops = self.engine.unpack_val(
            rows, F, E)
        block_dt = time.time() - t_block
        self.theta, self.opt_state = new_theta, new_opt_state
        # a snapshot serializes experiment.opt_state next to theta
        self.experiment.opt_state = self.opt_state
        # adopt the merged scoreboard before the stats: a block ends on a
        # snapshot iteration, whose snapshot must see the merged podium
        pre = [float(np.float32(s)) for _, s in it.best_elites()]
        final = [float(s) for s in etops[b - 1]] if E else []
        self._elites_dev = e_rows
        if final != pre:
            it.adopt_merged_scores([s for s in final if np.isfinite(s)])
            self._podium_dirty = True
        for k in range(b):
            if k:
                it.incr_iteration()
                logger.info("********** Iteration %d (chained) **********",
                            it.iteration())
            self._record_stats(fits_all[k], ratios[k], [norms[k]],
                               float(vals[k]), block_dt / b, plot,
                               best_acc=float(etops[k][0]) if E else None)

    # ---- main loop ----------------------------------------------------------

    def _chain_gap(self, nxt: int) -> int:
        """Fused validation runs inside a block; host validation ends one at
        each validating iteration, so with val_freq 1 every generation runs
        alone. SM-G with its sensitivity computed on the host (fixed for
        the whole dispatch) runs every generation alone (JAX: nes.py:
        1066-1077), and so does a host-scored task's (nes.py:1053-1055)."""
        if not self.task.fitness_on_device:
            return 1
        if self.mutation.is_gradient and not self.engine.inline_sens:
            if not self._block_warned:
                self._block_warned = True
                logger.warning(
                    "gens_per_dispatch>1 is incompatible with SM-G-* when "
                    "the sensitivity is host-computed (fixed at block "
                    "entry); driving per-generation")
            return 1
        if self._val_fused:
            return 1 << 30
        vf = max(self.tpu_cfg.val_freq, 1)
        return 1 if vf == 1 else self._gap_to_next(nxt, vf)

    def _record_eval(self, eval_score, fresh: bool = True):
        """Eval-result + podium bookkeeping, while self.theta is still the
        pre-update model of the generation the score belongs to (the
        reference pairs eval scores with the pre-update .pth,
        nic_nes_worker.py:92-113). ``fresh=False``: a score carried from an
        earlier validation is recorded but never submitted to the podium."""
        if not fresh:
            self.it.record_eval_result(0, self._current_path, eval_score)
            return
        if self._podium_would_take(eval_score):
            self._write_current_model()
        self.it.record_eval_result(0, self._current_path, eval_score)
        self.it.process_evaluated_elites()

    def _record_stats(self, fitnesses, ratio, norm_vec, eval_score, dt,
                      plot, best_acc=None):
        """Stats + snapshot for one completed generation, after the update:
        the snapshot's current_model is the post-update theta (the
        reference's resume point). ``best_acc`` replaces the podium's best
        score on the fused-validation path, whose interior generations'
        podiums exist only on the card."""
        config, it, stats = self.config, self.it, self.stats
        stats.record_update_ratio(float(ratio))
        stats.record_score_stats(np.asarray(fitnesses).ravel())
        stats.record_bs_stats(it.batch_size())
        stats.record_step_time_stats(dt=dt)
        stats.record_norm_stats(norm_vec)
        stats.record_acc_stats(eval_score)
        stats.record_best_acc_stats(
            it.best_elites()[0][1] if best_acc is None else best_acc)
        stats.record_std_stats(it.noise_stdev())
        stats.update_mem_stats()
        stats.log_stats()
        it.log_stats()
        if config.snapshot_freq and it.iteration() % config.snapshot_freq == 0:
            self._materialize_podium()  # z_info references the slot files
            self._write_current_model()  # z_info references this file
            save_snapshot(stats, it, self.experiment,
                          loader_state=self.loader_state())
            self._last_snapshot_iter = it.iteration()
            if plot:
                stats.plot_stats(self.experiment.snapshot_dir())

    def _fresh_eval(self) -> tuple[float, bool]:
        """(score, fresh) of this iteration's validation of the pre-update
        theta (reference: nic_nes/iteration.py:49-50); tpu.val_freq > 1
        thins it to every k iterations, carrying the last score."""
        fresh = (self.it.iteration() % max(self.tpu_cfg.val_freq, 1) == 0
                 or self._last_eval is None)
        if fresh:
            self._last_eval = self.task.validate(self.theta)
        return self._last_eval, fresh

    def _block_step(self, b: int, t_block: float, sigma, seeds, idx, sens,
                    F: int, plot: bool):
        """``b`` device-scored generations in one block, validated on the
        host at its start, then each one's bookkeeping."""
        it = self.it
        new_theta, new_opt_state, packs = self.engine.generation_block(
            self.theta, self.opt_state, sens, sigma, seeds, idx,
            self.optimizer.stepsize, self.config.l2coeff or 0.0)
        eval_score, fresh = self._fresh_eval()
        self._record_eval(eval_score, fresh=fresh)
        fits_all, ratios, norms = self.engine.unpack(packs, F)
        block_dt = time.time() - t_block
        self.theta, self.opt_state = new_theta, new_opt_state
        # a snapshot serializes experiment.opt_state next to theta
        self.experiment.opt_state = self.opt_state
        for k in range(b):
            if k:
                it.incr_iteration()
                logger.info("********** Iteration %d (chained) "
                            "**********", it.iteration())
                self._record_eval(eval_score, fresh=False)
            self._record_stats(fits_all[k], ratios[k], [norms[k]],
                               eval_score, block_dt / b, plot)

    def _host_step(self, t_block: float, sigma, seeds, idx, sens,
                   plot: bool):
        """One host-scored generation (JAX: nes.py:1225-1228,1271-1284):
        the rollouts, their fitnesses scored on the host, the validation of
        the pre-update theta, then the step with the carried deltas."""
        artifacts, deltas = self.engine.eval_generation(
            self.theta, sens, sigma, seeds, idx)
        fitnesses = self.engine.host_fitness(artifacts, idx, len(seeds))
        del artifacts
        eval_score, fresh = self._fresh_eval()
        self._record_eval(eval_score, fresh=fresh)
        self.opt_state, self.theta, ratio = self.engine.update(
            self.theta, self.opt_state, sens, sigma, seeds, fitnesses,
            self.optimizer.stepsize, self.config.l2coeff or 0.0,
            deltas=deltas)
        del deltas
        self.experiment.opt_state = self.opt_state  # before a snapshot
        self._record_stats(fitnesses, float(ratio),
                           [float(self.theta.abs().mean())], eval_score,
                           time.time() - t_block, plot)

    def run_master(self, plot: bool = False,
                   max_iterations: int | None = None):
        config, it, stats = self.config, self.it, self.stats
        limit = max_iterations or config.max_nb_iterations
        F = self._pair_count()
        self._val_fused = self._val_fused_mode()
        if self._val_fused:
            logger.info("fused validation: every generation validates on "
                        "the card; the podium stays there")

        while not limit or it.iteration() < limit:
            it.incr_epoch()
            gens = max(self.task.train_n // it.batch_size(), 1)
            done = 0
            while done < gens and (not limit or it.iteration() < limit):
                b = self._block_budget(gens - done, limit)
                done += b
                it.incr_iteration()
                stats.set_step_tstart()
                t_block = time.time()
                logger.info("********** Iteration %d%s **********",
                            it.iteration(),
                            f" (+{b - 1} chained)" if b > 1 else "")
                self._profile_hook(it.iteration(), b)

                sigma, bs = it.get_noise_stdev(), it.batch_size()
                # per-generation draws in stream order, so the trajectory is
                # the same for every block size
                seeds = np.empty((b, F), np.uint32)
                idx = None
                for k in range(b):
                    seeds[k] = self._rng.integers(0, 2**32, size=F,
                                                  dtype=np.uint32)
                    row = self._draw_batches(F, bs)
                    if idx is None:
                        idx = np.empty((b, *row.shape), row.dtype)
                    idx[k] = row
                sens = self._maybe_sensitivity(idx[0, 0], seeds[0, 0])

                if self._val_fused:
                    self._val_fused_step(b, t_block, sigma, seeds, idx, sens,
                                         F, plot)
                    if it.patience_reached() or it.schedule_reached():
                        if config.stepsize_divisor:
                            self.optimizer.stepsize /= config.stepsize_divisor
                        self._sampler = None
                        break  # rebuild the epoch at the new batch size
                    continue

                if not self.task.fitness_on_device:
                    self._host_step(t_block, sigma, seeds[0], idx[0], sens,
                                    plot)
                else:
                    self._block_step(b, t_block, sigma, seeds, idx, sens, F,
                                     plot)

                if it.patience_reached() or it.schedule_reached():
                    if config.stepsize_divisor:
                        self.optimizer.stepsize /= config.stepsize_divisor
                    self._sampler = None  # rebuilt at the new batch size
                    break  # rebuild the epoch at the new batch size

        self._profile_finalize()  # in case the run ended in its dispatch
        # skip the final snapshot when the loop's freq snapshot just wrote
        # this exact iteration
        if self._last_snapshot_iter != it.iteration():
            self._materialize_podium()
            self._write_current_model()
            save_snapshot(stats, it, self.experiment,
                          loader_state=self.loader_state())
            if plot:
                stats.plot_stats(self.experiment.snapshot_dir())
        return self.theta
