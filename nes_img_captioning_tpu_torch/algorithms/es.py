"""NIC-ES (port of ``nes_img_captioning_tpu/algorithms/es.py``): the
truncation-selection genetic algorithm's ``ESEngine`` and ``ESMaster``.

A population of parents makes ``nb_offspring`` children per generation by
Gaussian mutation (parent drawn uniformly, or by tournament = the smallest
of k sampled indices, since parents are sorted best first); the children are
scored on the generation's batch; the top ``population_size - num_elites``
become the next parents behind the podium's elites; the top
``num_elite_cands`` are validated during the next generation and the best
becomes the policy (reference: src/algorithm/nic_es/).

Offspring exist as (parent index, uint32 seed) pairs. A child is
``parent + shape_noise(sigma * N(0, 1), parent)`` with the noise drawn from
its seed (``ops/mutation.build_children``), in torch parameter order; each
chunk of ``tpu.pop_chunk`` children is scored by one ``task.rollout``: the
captioner lays them out in decode order and decodes them in one launch of
K1 per block of 128 rows (``CocoTask.rollout``; K4 with
``tpu.decode_vocab_tile``, K3 for the sampling kinds), or with its eager
decoder (the norm variants), MNIST evaluates them as they are
(``MnistTask.rollout``). Generation 0 is fresh random inits, one
per seed.

With ``tpu.es_decode_layout: true`` (M13b; "auto" resolves off, as in the
JAX package) and a task with a decode layout, the children are built in
decode order instead: ``parent_dec + scale_dec * N(0, 1)`` over the padded
decode-ordered axis (``ops/mutation.build_children_dec``; the parents and
the scale rows laid out once per generation, pad lanes at scale 0), go
straight into ``CocoTask.rollout_dec`` with no per-offspring ``to_dec``,
and come back to torch order through the exact ``from_dec`` where they are
kept. The noise is drawn over dim_dec, not dim: another stream than the
torch-order path's for the same seeds, as in the JAX package.

Under a process group (``tpu.mesh_shape``, ``parallel/``) every rank
draws the same seeds, parents and batches, sweeps its shard of the
offspring, and selects from the gathered fitnesses; the fused paths then
rebuild the winners from their seeds (``_gen_core``). Trajectories are
bitwise those of one process.

Three ways to run a generation, as in the JAX package:

* plain (``ESMaster._plain_step``): host validation of the previous
  candidates, the sweep, the fitness pulled, selection on the host, the
  winners rebuilt from their seeds (``ESEngine.materialize``);
* fused (``ESEngine.fused_generation``): parent assembly, sweep, selection,
  candidates and their validation on the card (``CocoTask.validate_device``)
  with no host sync until the one packed pull. The winners are kept from the
  sweep itself: after each chunk, a device-side stable merge keeps the best
  ``n_keep`` children seen so far in a pool of ``n_keep + chunk`` rows, so
  no seed has to come back to the host and no more than that pool is held.
  The pool's order is ``argsort(-fitness, stable=True)`` over the whole
  population, and its rows are the bits ``materialize`` rebuilds;
* blocked (``ESEngine.fused_block``, ``tpu.gens_per_dispatch``): K fused
  generations in a row with the podium merged on the card
  (``podium_merge``) and one pull for the block.

Safe mutations divide a child's noise by a sensitivity: SM-VECTOR by its
one precomputed vector, SM-G-SUM and SM-G-ABS by the row of its parent,
computed each generation from the parent set over the first
``tpu.sensitivity_batch`` rows of the generation's batch
(``ops/sensitivity.calc_sensitivities``): on the plain path by
``ESMaster._update_sensitivities`` before the sweep, on the fused paths on
the card inside the generation from the assembled parents, with no host
sync (JAX: es.py:288-321). A row is the same bits on every path.

A host-scored task (the captioner with ``tpu.device_cider`` off, or a
vocabulary too large for the device scorer) runs the plain path only: its
sweep returns the children's tokens and the master scores them
(``task.host_fitness``); the fused paths need the device scorer (JAX:
es.py:856-870).

``tpu.profile`` traces the dispatch that runs generation 2
(``MasterBase._profile_hook``).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .engine_base import PopulationEngine, to_device
from .experiment import ESExperiment
from .master_base import MasterBase
from .snapshot import save_snapshot
from ..ops.mutation import (
    MutationKind,
    build_children,
    build_children_dec,
    normal_from_seed,
    proportional_factor,
)
from ..ops.noise import lane_seeds
from ..ops.sensitivity import calc_sensitivities
from ..utils.files import remove_all_files_but

logger = logging.getLogger(__name__)

__all__ = ["ESEngine", "ESMaster", "podium_merge"]


def _identity(x):
    return x


def podium_merge(e_rows: torch.Tensor, e_scores: torch.Tensor,
                 c_rows: torch.Tensor, c_scores: torch.Tensor):
    """Merge candidates into the device scoreboard with
    ``Podium.record_elites``' exact semantics: one stable descending sort
    over the incumbents, then the candidates, so a tie keeps the incumbent
    and equal-scored candidates enter in their order. e_rows (E, dim),
    e_scores (E,), c_rows (C, dim), c_scores (C,) -> (rows (E, dim), scores
    (E,)), on the device, with no host sync. The rows are selected with
    ``index_select``, which copies them exactly (JAX: es.py:50-64, a one-hot
    product there)."""
    E = e_rows.shape[0]
    scores = torch.cat([e_scores, c_scores])
    top = torch.argsort(-scores, stable=True)[:E]
    pool = torch.cat([e_rows, c_rows])
    return pool.index_select(0, top), scores.index_select(0, top)


class ESEngine(PopulationEngine):
    """Device-side math for NIC-ES generations: one card, or this rank's
    shard of the population under a process group (``mesh``)."""

    def __init__(self, task, mutation: MutationKind, pop_chunk: int = 0,
                 use_layout: object = "auto", mesh=None, **sens):
        """``use_layout``: only True builds the children in decode order
        (``tpu.es_decode_layout``; "auto" resolves off, as in the JAX
        package, es.py:583-591), and only where the task has a decode
        layout (fused decode, device scoring); ``mesh``: this rank's
        ``RankGroup``; ``sens``: the SM-G settings of ``PopulationEngine``."""
        super().__init__(task, pop_chunk=pop_chunk, mutation=mutation,
                         mesh=mesh, **sens)
        # an identity check: a truthy near-miss such as 1 stays off
        self._layout = (getattr(task, "decode_layout", None)
                        if use_layout is True else None)
        # kinds whose noise scale differs per parent: the SM-G rows and the
        # SM-PROPORTIONAL factors; the others share one scale row
        self._per_parent_scale = (mutation.is_gradient
                                  or mutation.is_proportional)
        self.device = task.device

    # ---- the test seams: what a child's randomness is -------------------------

    def normal_of(self, seed: int) -> torch.Tensor:
        """The N(0, 1) noise of offspring ``seed``, f32 on the device:
        (dim,) in torch order, (dim_dec,) over the padded decode-ordered
        axis with the layout. Tests replace this with the JAX package's
        realized noise."""
        n = self.dim if self._layout is None else self._layout.dim_dec
        return normal_from_seed(seed, n, self.device)

    def fresh_of(self, seed: int) -> torch.Tensor:
        """Generation 0's child of ``seed``: a random init from its own
        generator (JAX: es.py:215-230). Tests replace this too."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return self.task.generate_theta(gen).to(torch.float32)

    def lanes_of(self, seeds) -> np.ndarray:
        """The sampling kinds' (M, seq_per_img) lane seeds of offspring
        ``seeds`` (``ops/noise.lane_seeds`` with sign +1)."""
        return lane_seeds(seeds, np.ones(len(seeds), np.int64),
                          self.task.seq_per_img)

    # ---- sensitivities, children and their rollouts -----------------------

    def sensitivities(self, parents, sens_idx, seed0: int) -> torch.Tensor:
        """The post-processed SM-G rows (P, dim) of the parents over the
        batch rows ``sens_idx`` (host), in groups of ``SENS_GROUP``; the probe
        estimator's matrix comes from ``probes_of(seed0, ...)``. Host
        operands reach the card through pinned memory: no host sync."""
        idx_d, probes = self._sens_operands(sens_idx, seed0, self.device)
        return calc_sensitivities(self.task, parents, idx_d, self.mutation,
                                  self._sens_underflow, self._sens_precision,
                                  probes)

    def _factors(self, parents):
        """Each parent row's SM-PROPORTIONAL factor, one row at a time (the
        same reduction whichever path builds the children), or None."""
        if parents is None or not self.mutation.is_proportional:
            return None
        return torch.stack([proportional_factor(p) for p in parents])

    def _scale_rows_dec(self, parents, sigma, sens):
        """The layout's noise-scale rows (R, dim_dec): a child's delta is
        its row times N(0, 1), the row ``shape_noise``'s factors of
        (sigma, parent, sensitivity), laid out with pads 0 (JAX: es.py:
        145-170). Per-parent rows for SM-G (``sens`` (P, dim)) and
        SM-PROPORTIONAL; one shared row otherwise (SM-VECTOR's ``sens``
        (dim,))."""
        scale = torch.full((self.dim,), float(sigma), dtype=torch.float32,
                           device=self.device)
        if self.mutation.is_safe:
            scale = scale / sens
        if self.mutation.is_proportional:
            scale = scale * self._factors(parents)
        return self._layout.to_dec(scale.reshape(-1, self.dim),
                                   pad_scale=0.0)

    def _child_ctx(self, parents, sigma, sens=None):
        """(build, rollout, finish) of one generation's children (JAX:
        es.py:172-200). ``build(seeds, pidx_d)`` makes the children of host
        seeds and device parent rows in rollout space: decode order with
        the layout, torch order otherwise; ``rollout(children, seeds,
        idx_d, consts)`` is the matching task entry; ``finish`` maps built
        children back to torch order (the exact ``from_dec`` with the
        layout). The parents and scale rows are laid out once here, never
        per offspring. ``parents`` None: generation 0's fresh inits."""
        if parents is None:
            return (lambda seeds, _: torch.stack([self.fresh_of(s)
                                                  for s in seeds]),
                    self._rollout, _identity)
        lay = self._layout
        if lay is None:
            factors = self._factors(parents)

            def build(seeds, pidx_d):
                noise = torch.stack([self.normal_of(int(s)) for s in seeds])
                return build_children(parents, pidx_d, noise, float(sigma),
                                      factors, sens)

            return build, self._rollout, _identity
        parents_dec = lay.to_dec(parents)
        scale_dec = self._scale_rows_dec(parents, sigma, sens)

        def build_dec(seeds, pidx_d):
            noise = torch.stack([self.normal_of(int(s)) for s in seeds])
            return build_children_dec(parents_dec, scale_dec, pidx_d, noise)

        return build_dec, self._rollout_dec, lay.from_dec

    def _lanes(self, seeds):
        return (self.lanes_of(seeds) if getattr(self.task, "samples", False)
                else None)

    def _rollout(self, children, seeds, idx_d, consts) -> dict:
        """Torch-order children's artifact: ``{"fitness"}`` from a
        device-scored task, the tokens of a host-scored one."""
        return self.task.rollout(children, idx_d, consts=consts,
                                 lanes=self._lanes(seeds))

    def _rollout_dec(self, children, seeds, idx_d, consts) -> dict:
        """Decode-ordered children's ``{"fitness"}``: straight into the
        kernels (``CocoTask.rollout_dec``), no per-offspring ``to_dec``."""
        idx = idx_d.reshape(1, -1).expand(children.shape[0], -1)
        return {"fitness": self.task.rollout_dec(
            children, idx, consts=consts, lanes=self._lanes(seeds))}

    def _chunks(self, seeds, pidx):
        """(n_chunks, chunk, host seed rows (n_chunks, chunk), device pidx
        rows): the population padded by repeating its last member."""
        n_chunks, chunk = self._plan(len(seeds))
        seeds_l = self._lay_out(np.asarray(seeds, np.uint32), n_chunks, chunk)
        pidx_l = None
        if pidx is not None:
            pidx_l = to_device(
                self._lay_out(np.asarray(pidx, np.int64), n_chunks, chunk),
                self.device)
        return n_chunks, chunk, seeds_l, pidx_l

    def _sweep(self, ctx, plan, seeds, pidx, idx_row, consts):
        """Yields (real members of the chunk, children in rollout space,
        artifact) for each chunk of this rank's shard of the sweep."""
        build, rollout, _ = ctx
        n_chunks, chunk, seeds_l, pidx_l = self._chunks(
            plan.local(seeds), None if pidx is None else plan.local(pidx))
        idx_d = to_device(np.asarray(idx_row, np.int64), self.device)
        for c in range(n_chunks):
            children = build(seeds_l[c], None if pidx_l is None
                             else pidx_l[c])
            yield (min(chunk, plan.per_rank - c * chunk), children,
                   rollout(children, seeds_l[c], idx_d, consts))

    def _gen_core(self, parents, sigma, seeds, pidx, idx_row, consts, vconsts,
                  n_keep: int, n_cands: int, sens=None, sens_idx=None):
        """One generation on the card given the assembled (P, dim) parents:
        for SM-G their sensitivities over the batch rows ``sens_idx``, then
        the sweep, truncation selection, the kept children and the
        candidates' validation (JAX: es.py:279-353). ``sens``: SM-VECTOR's
        vector (SM-G computes its own; other kinds ignore ``sens_idx``).
        One rank keeps the winners from the sweep in a pool of n_keep +
        chunk rows (in rollout space) with no host sync; several ranks
        gather the fitnesses and rebuild the winners from their seeds, the
        same bits (``materialize``), since each rank's pool holds its own
        shard only. SM-G rows and the validation are whole on every rank.
        Returns (fitness (L,), selected (n_keep, dim) best first,
        candidates (n_cands, dim) = its prefix, candidate scores
        (n_cands,))."""
        L = len(seeds)
        if self.mutation.is_gradient:
            sens = self.sensitivities(parents, sens_idx, seeds[0])
        ctx = self._child_ctx(parents, sigma, sens)
        plan = self._shard(L)
        sweep = self._sweep(ctx, plan, seeds, pidx, idx_row, consts)
        if plan.world > 1:
            fitness = self._gather(torch.cat(
                [art["fitness"][:n] for n, _, art in sweep]), plan)
            keep = torch.argsort(-fitness, stable=True)[:n_keep].cpu().numpy()
            build, _, finish = ctx
            selected = finish(build(np.asarray(seeds, np.uint32)[keep],
                                    to_device(np.asarray(pidx, np.int64)[keep],
                                              self.device)))
        else:
            fitness, selected = self._keep_best(sweep, ctx[2], n_keep)
        cands = selected[:n_cands]
        cand_scores = torch.stack([self.task.validate_device(th, vconsts)
                                   for th in cands])
        return fitness, selected, cands, cand_scores

    def _keep_best(self, sweep, finish, n_keep: int):
        """(fitness (L,), the best n_keep children best first in torch
        order) of a whole sweep, with no host sync: after each chunk a
        stable merge keeps the best n_keep children seen so far in a pool of
        n_keep + chunk rows."""
        pool = pool_fit = kept = free = None
        fits = []
        for n, children, art in sweep:
            fit = art["fitness"]
            if pool is None:
                S = n_keep + children.shape[0]
                pool = children.new_empty((S, children.shape[1]))
                pool_fit = fit.new_empty(S)
                kept = torch.empty(0, dtype=torch.int64, device=self.device)
                free = torch.arange(S, device=self.device)
            fits.append(fit[:n])
            slots = free[:n]
            pool.index_copy_(0, slots, children[:n])
            pool_fit.index_copy_(0, slots, fit[:n])
            # the kept slots, best first, then the chunk's in member order:
            # every kept member precedes the chunk's, so this stable sort is
            # the population's stable order restricted to these members
            cand = torch.cat([kept, slots])
            order = cand.index_select(
                0, torch.argsort(-pool_fit.index_select(0, cand),
                                 stable=True))
            kept, free = order[:n_keep], torch.cat([order[n_keep:],
                                                    free[n:]])
        return torch.cat(fits), finish(pool.index_select(0, kept))

    # ---- host entry points ------------------------------------------------------

    def eval_generation(self, parents, sigma, seeds: np.ndarray,
                        pidx: np.ndarray | None, idx_row: np.ndarray,
                        fresh: bool = False, sens=None) -> dict:
        """The plain path's sweep: seeds (L,) uint32, pidx (L,) parent rows
        (ignored when ``fresh``), idx_row (B,), ``sens`` the safe kinds'
        sensitivity (``build_children``) -> the artifact with a leading
        member axis on the device: ``{"fitness"}``, or a host-scored task's
        tokens (JAX: es.py:423-441). Under a group the rank's shard's
        (``ShardPlan.per_rank`` members); ``host_fitness`` gathers."""
        parents = None if fresh else parents
        plan = self._shard(len(seeds))
        arts = [art for _, _, art in self._sweep(
            self._child_ctx(parents, sigma, sens), plan, seeds,
            None if fresh else pidx, idx_row, self.task.device_consts())]
        return {k: torch.cat([a[k] for a in arts])[:plan.per_rank]
                for k in arts[0]}

    def materialize(self, parents, sigma, seeds, pidx, fresh: bool = False,
                    sens=None) -> torch.Tensor:
        """Rebuild the children of (seeds, pidx) from their lineage, in
        torch order: the same builder as the sweep, so the same bits (JAX:
        es.py:544-555); with the layout, the decode-ordered children mapped
        back by the exact ``from_dec``."""
        build, _, finish = self._child_ctx(None if fresh else parents, sigma,
                                           sens)
        pidx_d = None if fresh else to_device(np.asarray(pidx, np.int64),
                                              self.device)
        return finish(build(np.asarray(seeds, np.uint32), pidx_d))

    def fused_generation(self, elite_rows, n_valid: int, selected_prev, sigma,
                         seeds: np.ndarray, pidx: np.ndarray,
                         idx_row: np.ndarray, policy, n_cands: int,
                         sens=None, sens_idx=None):
        """One generation, with no host sync in one process (JAX: es.py:
        240-277,443-475; under a group the fitnesses' gather syncs).
        Parents: row i = elite_rows[i] for i < n_valid, then the previous
        selected children, rows past the true count repeating the last
        child (never drawn: pidx < n_parents). ``sens``: SM-VECTOR's
        vector; ``sens_idx``: SM-G's batch rows (``_gen_core``). Returns
        (packed, selected, cands), packed = [fitness (L) | cand scores (C) |
        mean|policy|] read by ``unpack_fused`` in the generation's one
        sync."""
        E = elite_rows.shape[0]
        parents = torch.cat([elite_rows[:n_valid], selected_prev,
                             selected_prev[-1:].expand(E - n_valid, -1)])
        fitness, selected, cands, cand_scores = self._gen_core(
            parents, sigma, seeds, pidx, idx_row, self.task.device_consts(),
            self.task.device_val_consts(), selected_prev.shape[0], n_cands,
            sens, sens_idx)
        packed = torch.cat([fitness, cand_scores,
                            policy.abs().mean().reshape(1)])
        return packed, selected, cands

    @staticmethod
    def unpack_fused(packed, L: int, n_cands: int):
        """(fitness (L,), cand_scores (C,), mean|policy|): one sync."""
        arr = packed.detach().cpu().numpy()
        return arr[:L], arr[L:L + n_cands], float(arr[-1])

    def fused_block(self, elite_rows, elite_scores, selected_prev, cand_rows,
                    cand_scores, sigma, seeds: np.ndarray, pidx: np.ndarray,
                    idx_rows: np.ndarray, n_cands: int, sens=None,
                    sens_idx=None):
        """K generations in a row on the card (JAX: es.py:355-421,483-533):
        each assembles its parents from the podium as it stood BEFORE
        merging the previous generation's candidates, merges them
        (``podium_merge``), takes the best previous candidate (first
        argmax) as the policy and runs the generation. seeds, pidx (K, L),
        idx_rows (K, B); ``sens`` as in fused_generation, ``sens_idx`` (K,
        B_s) the SM-G batch rows of each generation. Returns (packed (K, L
        + C + 1 + E), elite_rows, elite_scores, selected, cand_rows,
        policy); packed rows are
        [fitness | cand scores | mean|policy| | elite scores after the
        merge], read by ``unpack_block`` in the block's one sync."""
        E = elite_rows.shape[0]
        e_rows, selected, c_rows = elite_rows, selected_prev, cand_rows
        e_scores = to_device(np.asarray(elite_scores, np.float32),
                              self.device)
        c_scores = to_device(np.asarray(cand_scores, np.float32),
                              self.device)
        consts = self.task.device_consts()
        vconsts = self.task.device_val_consts()
        rows, policy = [], None
        for k in range(seeds.shape[0]):
            parents = torch.cat([e_rows, selected])
            if E:
                e_rows, e_scores = podium_merge(e_rows, e_scores, c_rows,
                                                c_scores)
            policy = c_rows.index_select(0, c_scores.argmax().reshape(1))[0]
            fitness, selected, c_rows, c_scores = self._gen_core(
                parents, sigma, seeds[k], pidx[k], idx_rows[k], consts,
                vconsts, selected_prev.shape[0], n_cands, sens,
                None if sens_idx is None else sens_idx[k])
            rows.append(torch.cat([fitness, c_scores,
                                   policy.abs().mean().reshape(1),
                                   e_scores]))
        return torch.stack(rows), e_rows, e_scores, selected, c_rows, policy

    @staticmethod
    def unpack_block(packed, K: int, L: int, n_cands: int, n_elites: int):
        """(fitness (K, L), cand_scores (K, C), norms (K,), post-merge elite
        scores (K, E)): the block's one sync."""
        arr = packed.detach().cpu().numpy().reshape(
            K, L + n_cands + 1 + n_elites)
        return (arr[:, :L], arr[:, L:L + n_cands], arr[:, L + n_cands],
                arr[:, L + n_cands + 1:])


class ESMaster(MasterBase):
    """The NIC-ES training loop (port of ``ESMaster`` in
    ``nes_img_captioning_tpu/algorithms/es.py``): parents, candidates and
    the podium's rows on the card, bookkeeping on the host; one card, or
    one rank of a process group (``MasterBase``).

    The host numpy RNG is drawn as the JAX package draws it (candidate
    seeds of generation 0; per generation the batch, the offspring seeds,
    then the parent indices), so for the same ``tpu.seed`` both packages
    sweep the same seeds, parents and batches; only the realized noise
    differs. A resumed run continues the seeds (``MasterBase``); the JAX
    package's ESMaster starts them again from ``tpu.seed``.

    Every mutation kind runs: SM-G-SUM and SM-G-ABS with their per-parent
    sensitivities (``tpu.sensitivity_*``), SM-VECTOR with the vector of
    ``safe_mutation_vector``; a host-scored task on the plain path.
    ``tpu.es_decode_layout: true`` builds the children in decode order."""

    def __init__(self, exp: dict, device=None, data=None, mesh=None):
        """``device``, ``data`` and ``mesh`` as ``MasterBase`` takes
        them."""
        super().__init__(exp, device=device, data=data, mesh=mesh)
        tpu = self.tpu_cfg
        self.experiment = ESExperiment(exp, self.config, self.task)
        # "auto" resolves off, as in the JAX package (es.py:587-591)
        self.engine = ESEngine(self.task, self.mutation,
                               pop_chunk=tpu.pop_chunk,
                               use_layout=tpu.es_decode_layout,
                               mesh=self.mesh,
                               sens_underflow=self._underflow,
                               sens_precision=tpu.sensitivity_precision,
                               sens_probes=tpu.sensitivity_probes)

        self._elite_path_tpl = os.path.join(
            self.experiment.elite_dir(), "0_{i}_elite_params.pth")
        self._parent_path_tpl = os.path.join(
            self.experiment.offspring_dir(), "0_{i}_parent_params.pth")

        self._theta_cache: dict = {}
        # device copies of the current elite candidates, keyed by their
        # .pth path (the files are the podium's and the checkpoint's)
        self._cand_thetas: dict = {}
        self._elite_rows_cache: tuple | None = None
        self._padded_elite_cache: tuple | None = None
        # parents: a device matrix (P, dim), or None for the fresh
        # generation 0 and on the fused paths; podium-elite rows are tracked
        # by path for z_info
        self.parents_mat = None
        self._parent_paths: list = []
        self._n_parents = 0
        self.elites_to_evaluate: list = []  # (cand_id, path)
        self.policy_theta = None  # the best evaluated candidate
        # fused state: the previous generation's selected children (P - E,
        # dim) and the device scores of the pending candidates
        self._selected_dev = None
        self._n_selected = 0
        self._cand_scores_pending = None
        # blocked state: the pending candidates (and the podium's rows in
        # _elites_dev); dropped by any step that goes through the host podium
        self._cands_dev = None
        self._fused_capable_cache = None

        self._init_population(exp)

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    # ---- init modes -----------------------------------------------------------------

    def _init_population(self, exp):
        spec = self.task.spec
        n_cands = self.experiment.num_elite_cands()
        if exp.get("from_infos"):
            infos = self._resume(exp["from_infos"])
            thetas = [spec.load_pth(path) for _, path in infos["parents"]]
            self._set_parents(self._place(torch.stack(thetas)),
                              [None] * len(thetas))
            self.elites_to_evaluate = []
            for i, (_, path) in enumerate(infos["elites_to_evaluate"]):
                new_path = self._elite_path_tpl.format(i=i)
                if os.path.abspath(path) != os.path.abspath(new_path):
                    spec.save_pth(spec.load_pth(path), new_path)
                self.elites_to_evaluate.append((i, new_path))
            self.policy_theta = self.parents_mat[0]
        elif exp.get("from_single"):
            files = exp["from_single"]
            if isinstance(files, str):
                files = [files]
            thetas = [spec.load_pth(f) for f in files]
            self._set_parents(self._place(torch.stack(thetas)),
                              [None] * len(thetas))
            self.elites_to_evaluate = []
            for i, th in enumerate(thetas[:n_cands]):
                path = self._elite_path_tpl.format(i=i)
                spec.save_pth(th, path)
                self.elites_to_evaluate.append((i, path))
                self._cand_thetas[path] = self._place(th)
            self.policy_theta = self.parents_mat[0]
        else:
            # generation 0 is fully random (parents None, reference
            # nic_es/iteration.py:50-61); the candidates are random models
            cand_seeds = self._rng.integers(0, 2**32, size=max(n_cands, 1),
                                            dtype=np.uint32)
            cands = self.engine.materialize(None, 0.0, cand_seeds, None,
                                            fresh=True)
            cands_host = cands.cpu()
            for i in range(n_cands):
                path = self._elite_path_tpl.format(i=i)
                spec.save_pth(cands_host[i], path)
                self.elites_to_evaluate.append((i, path))
                self._cand_thetas[path] = cands[i]
            self.policy_theta = cands[0]

    def _set_parents(self, mat: torch.Tensor, paths: list):
        """Install the parent set, padded to population_size rows by
        repeating row 0 (never drawn: parent indices are drawn over the
        true count, ``_n_parents``)."""
        P = max(self.experiment.population_size(), mat.shape[0])
        self._n_parents = int(mat.shape[0])
        if mat.shape[0] < P:
            mat = torch.cat([mat, mat[:1].expand(P - mat.shape[0], -1)])
        self.parents_mat = mat
        self._parent_paths = paths

    def _load_theta_cached(self, path: str) -> torch.Tensor:
        """A podium .pth file, cached by (path, mtime)."""
        mtime = os.path.getmtime(path)
        hit = self._theta_cache.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        theta = self.task.spec.load_pth(path)
        self._theta_cache[path] = (mtime, theta)
        return theta

    def _device_elite_rows(self, elite_paths: list):
        """The podium elites' rows stacked on the device, uploaded again
        only when a slot file changed; None for an empty podium."""
        if not elite_paths:
            return None
        key = tuple((p, os.path.getmtime(p)) for p in elite_paths)
        if self._elite_rows_cache is not None \
                and self._elite_rows_cache[0] == key:
            return self._elite_rows_cache[1]
        rows = self._place(torch.stack([self._load_theta_cached(p)
                                        for p in elite_paths]))
        self._elite_rows_cache = (key, rows)
        return rows

    def _padded_elite_rows(self, elite_paths: list, E: int):
        """(E, dim) elite rows padded with zero rows (never selected: parent
        assembly maps rows >= n_valid to children). A full podium shares
        _device_elite_rows' cache."""
        if len(elite_paths) == E:
            dev = self._device_elite_rows(elite_paths)
            if dev is not None:
                self._padded_elite_cache = None
                return dev
        key = (tuple((p, os.path.getmtime(p)) for p in elite_paths), E)
        if self._padded_elite_cache is not None \
                and self._padded_elite_cache[0] == key:
            return self._padded_elite_cache[1]
        rows = torch.zeros((E, self.engine.dim), dtype=torch.float32)
        for i, p in enumerate(elite_paths[:E]):
            rows[i] = self._load_theta_cached(p)
        dev = self._place(rows)
        self._padded_elite_cache = (key, dev)
        return dev

    # ---- selection ----------------------------------------------------------------

    def _select_parent_indices(self, L: int, n_parents: int) -> np.ndarray:
        """Uniform parents, or tournament: the smallest of k indices drawn
        without replacement (parents are sorted best first; reference
        nic_es_worker.py:150-162), as one vectorized draw (JAX: es.py:
        791-803)."""
        if self.experiment.selection() == "tournament":
            k = min(n_parents, self.experiment.tournament_size() or 1)
            r = self._rng.random((L, n_parents))
            subset = np.argpartition(r, k - 1, axis=1)[:, :k]
            return subset.min(axis=1).astype(np.int32)
        return self._rng.integers(0, n_parents, size=L).astype(np.int32)

    def _update_sensitivities(self, idx_row, seed0):
        """The plain path's sensitivity operand of the sweep (JAX: es.py:
        805-834): SM-G's rows of the whole padded parent matrix over the
        generation's subsampled batch, the probes drawn from its member-0
        seed ``seed0``, as the fused paths compute them; SM-VECTOR's
        vector; None for the other kinds."""
        if self.mutation.is_gradient:
            return self.engine.sensitivities(
                self.parents_mat, self._sens_batch_rows(idx_row), seed0)
        return self._sens_vector

    # ---- main loop ------------------------------------------------------------------

    def _fused_capable(self) -> bool:
        """Whether generations may run fused (JAX: es.py:856-884): not
        ``tpu.fused_es: false``, device fitness (a host-scored task runs
        the plain path), at least as many offspring
        as kept children, 1 <= candidates <= min(kept, offspring), and the
        device validation constants."""
        if self._fused_capable_cache is None:
            n_keep = (self.experiment.population_size()
                      - self.experiment.num_elites())
            L = self.exp["nb_offspring"]
            self._fused_capable_cache = bool(
                self.tpu_cfg.fused_es is not False
                and self.task.fitness_on_device
                and L >= n_keep
                and 1 <= self.experiment.num_elite_cands() <= min(n_keep, L)
                and self.task.device_val_consts() is not None)
        return self._fused_capable_cache

    def _ensure_cand_file(self, path: str):
        """Write a device-resident candidate's .pth when something needs the
        file (the fused paths defer it)."""
        if os.path.isfile(path):
            return
        th = self._cand_thetas.get(path)
        if th is not None:
            self.task.spec.save_pth(th, path)

    def _cand_theta(self, path: str) -> torch.Tensor:
        th = self._cand_thetas.get(path)
        if th is None:  # resume: only the file exists
            th = self._place(self._load_theta_cached(path))
            self._cand_thetas[path] = th
        return th

    def _plain_step(self, idx_row, sigma, L, pop_size, num_elites, n_cands):
        """The host-choreographed generation (JAX: es.py:928-1038):
        validate the previous candidates, sweep, select, publish the
        candidates, install the parents. Returns (sorted fitness, best
        candidate score, mean|policy|)."""
        it, spec = self.it, self.task.spec

        # 1. validate the candidates published by the previous generation
        for cid, path in self.elites_to_evaluate:
            it.record_eval_result(cid, path,
                                  self.task.validate(self._cand_theta(path)))
        best_ev_acc, best_ev_elite = it.process_evaluated_elites()
        if best_ev_elite:
            self.policy_theta = (
                self._cand_thetas[best_ev_elite]
                if best_ev_elite in self._cand_thetas
                else self._place(spec.load_pth(best_ev_elite)))

        # 2. the offspring sweep
        fresh = self.parents_mat is None
        seeds = self._rng.integers(0, 2**32, size=L, dtype=np.uint32)
        sens = None
        if fresh:
            pidx = np.zeros(L, np.int32)
        else:
            sens = self._update_sensitivities(idx_row, seeds[0])
            pidx = self._select_parent_indices(L, self._n_parents)
        artifacts = self.engine.eval_generation(
            self.parents_mat, sigma, seeds, pidx, idx_row, fresh=fresh,
            sens=sens)
        fitness = self.engine.host_fitness(artifacts, idx_row, L).reshape(L)

        # 3. truncation selection (reference: nic_es_master.py:155-167)
        order = np.argsort(-fitness, kind="stable")
        scores = fitness[order]
        keep = order[:pop_size - num_elites]

        # 4. the next elite candidates: the top C children, as .pth files
        cand_ids = order[:n_cands]
        cand_thetas = self.engine.materialize(
            self.parents_mat, sigma, seeds[cand_ids], pidx[cand_ids],
            fresh=fresh, sens=sens)
        cand_host = cand_thetas.cpu()
        new_cands, cand_files, new_cand_thetas = [], [], {}
        for i in range(len(cand_ids)):
            path = self._elite_path_tpl.format(i=i)
            spec.save_pth(cand_host[i], path)
            new_cands.append((i, path))
            cand_files.append(path)
            new_cand_thetas[path] = cand_thetas[i]
        remove_all_files_but(self.experiment.elite_dir(), cand_files)
        self.elites_to_evaluate = new_cands
        self._cand_thetas = new_cand_thetas

        # 5. the next parents: podium elites, then the selected children
        #    (reference: record_parents + _add_elites_to_parents)
        selected = self.engine.materialize(
            self.parents_mat, sigma, seeds[keep], pidx[keep], fresh=fresh,
            sens=sens)
        del sens
        elite_paths = [path for path, _ in it.best_elites()
                       if path and os.path.isfile(path)]
        dev_elites = self._device_elite_rows(elite_paths)
        rows = ([dev_elites] if dev_elites is not None else []) + [selected]
        self._set_parents(torch.cat(rows),
                          elite_paths + [None] * selected.shape[0])

        # hand the fused path its state: the selected children padded to
        # the fixed P - E rows, and no device scores for the candidates
        self._elites_dev = None  # the host podium owns the slots here
        self._cands_dev = None
        if self._fused_capable():
            S = pop_size - num_elites
            sel = selected
            if sel.shape[0] < S:
                sel = torch.cat([sel, sel[-1:].expand(S - sel.shape[0],
                                                      -1)])
            self._selected_dev = sel
            self._n_selected = int(selected.shape[0])
            self._cand_scores_pending = None

        norm = float(self.policy_theta.abs().mean())
        return scores, best_ev_acc, norm

    def _fused_step(self, idx_row, sigma, L, pop_size, num_elites, n_cands):
        """One generation on the card (JAX: es.py:1040-1135). The candidate
        scores come from the previous generation's validation on the card
        (host validation at a boundary); this generation's parents take the
        podium's rows before the candidates are submitted."""
        it = self.it
        S = pop_size - num_elites
        elite_paths = [p for p in self._parent_paths if p is not None]
        n_valid = len(elite_paths)
        if (self._elites_dev is not None
                and self._elites_dev.shape[0] == num_elites
                and n_valid == num_elites):
            # block -> per-generation handoff: the merged rows are on the
            # card already (and _materialize_podium wrote the same bytes)
            dev_elites = self._elites_dev
        else:
            dev_elites = self._padded_elite_rows(elite_paths, num_elites)
        self._elites_dev = None  # this step merges the podium on the host

        if self._cand_scores_pending is None:
            scores = [float(self.task.validate(self._cand_theta(path)))
                      for _, path in self.elites_to_evaluate]
        else:
            scores = [float(s) for s in self._cand_scores_pending]
        # a candidate enters the podium only by beating its worst slot
        # (record_elites' stable merge): only then is its file needed
        min_slot = min((sc for _, sc in it.best_elites()),
                       default=float("-inf"))
        for (cid, path), score in zip(self.elites_to_evaluate, scores):
            if score > min_slot:
                self._ensure_cand_file(path)
            it.record_eval_result(cid, path, score)
        it.process_evaluated_elites()
        best_ev_acc = float("-inf")
        if scores:
            bi = int(np.argmax(scores))
            best_ev_acc = scores[bi]
            self.policy_theta = self._cand_theta(
                self.elites_to_evaluate[bi][1])

        seeds = self._rng.integers(0, 2**32, size=L, dtype=np.uint32)
        pidx = self._select_parent_indices(L, self._n_parents)
        packed, new_selected, new_cands = self.engine.fused_generation(
            dev_elites, n_valid, self._selected_dev, sigma, seeds, pidx,
            idx_row, self.policy_theta, n_cands, sens=self._sens_vector,
            sens_idx=self._sens_batch_rows(idx_row))
        fitness, cand_scores, norm = self.engine.unpack_fused(
            packed, L, n_cands)  # the generation's one host sync
        order = np.argsort(-fitness, kind="stable")

        # publish this generation's candidates: slot files deleted, so a
        # stale file cannot pass for a new candidate; written lazily
        remove_all_files_but(self.experiment.elite_dir(), [])
        self.elites_to_evaluate = []
        self._cand_thetas = {}
        for i in range(n_cands):
            path = self._elite_path_tpl.format(i=i)
            self.elites_to_evaluate.append((i, path))
            self._cand_thetas[path] = new_cands[i]
        self._cands_dev = new_cands
        self._cand_scores_pending = cand_scores
        self._selected_dev = new_selected
        self._n_selected = S
        self.parents_mat = None  # the fused representation owns the parents

        # parents of the next generation: the podium after this submission
        elite_paths_next = [p for p, _ in it.best_elites()
                            if p and os.path.isfile(p)]
        self._parent_paths = elite_paths_next + [None] * S
        self._n_parents = len(elite_paths_next) + S
        return fitness[order], best_ev_acc, norm

    def _chain_gap(self, nxt: int) -> int:
        """Blocks run only in the fused steady state (JAX: es.py:
        1137-1183): selected children and pending device candidates from a
        fused step, and a full podium (while it fills, the parent rows are
        not fixed)."""
        if (self._selected_dev is None or not self._fused_capable()
                or self._cands_dev is None
                or self._cand_scores_pending is None):
            return 1
        filled = [p for p, _ in self.it.best_elites()
                  if p and os.path.isfile(p)]
        return 1 << 30 if len(filled) == self.experiment.num_elites() else 1

    def _fused_block_step(self, b, t_block, sigma, bs, L, pop_size,
                          num_elites, n_cands):
        """``b`` generations with one pull (JAX: es.py:1185-1293). The
        per-generation bookkeeping is replayed from the block's rows; the
        merged podium's scores are adopted at once, its rows stay on the
        card until _materialize_podium. Slot files of podium states inside
        a block are never written (a block ends on every snapshot)."""
        it, stats = self.it, self.stats
        S = pop_size - num_elites
        if self._elites_dev is None:
            paths = [p for p, _ in it.best_elites() if p]
            self._elites_dev = self._padded_elite_rows(paths, num_elites)
        pre_scores = [float(s) for _, s in it.best_elites()]

        # per-generation draws in the per-generation stream order, so the
        # trajectory is the same for every block size
        idx_rows = np.empty((b, bs), np.int32)
        seeds = np.empty((b, L), np.uint32)
        pidx = np.empty((b, L), np.int32)
        for k in range(b):
            idx_rows[k] = self._sampler.batch(bs)
            seeds[k] = self._rng.integers(0, 2**32, size=L, dtype=np.uint32)
            pidx[k] = self._select_parent_indices(L, num_elites + S)
        sens_idx = np.stack([self._sens_batch_rows(r) for r in idx_rows])

        packed, e_rows, _, selected, c_rows, policy = self.engine.fused_block(
            self._elites_dev, pre_scores, self._selected_dev,
            self._cands_dev, self._cand_scores_pending, sigma, seeds, pidx,
            idx_rows, n_cands, sens=self._sens_vector, sens_idx=sens_idx)
        fit_all, cand_all, norms, etops = ESEngine.unpack_block(
            packed, b, L, n_cands, num_elites)  # the block's one sync
        block_dt = time.time() - t_block

        prev_cands = np.asarray(self._cand_scores_pending, np.float32)
        for k in range(b):
            if k:
                it.incr_iteration()
                logger.info("********** Iteration %d (chained) **********",
                            it.iteration())
            f = fit_all[k]
            stats.record_score_stats(f[np.argsort(-f, kind="stable")])
            stats.record_bs_stats(it.batch_size())
            stats.record_step_time_stats(dt=block_dt / b)
            stats.record_norm_stats([float(norms[k])])
            stats.record_acc_stats(
                float(prev_cands.max()) if prev_cands.size else 0.0)
            stats.record_best_acc_stats(float(etops[k][0]))
            stats.record_std_stats(it.noise_stdev())
            stats.update_mem_stats()
            stats.log_stats()
            it.log_stats()
            prev_cands = cand_all[k]

        # adopt the merged scores only when the merge changed the podium
        # (compared at f32: host-validated entries may carry f64 values)
        final_scores = [float(s) for s in etops[b - 1]]
        if final_scores != [float(np.float32(s)) for s in pre_scores]:
            it.adopt_merged_scores(final_scores)
            self._podium_dirty = True
        self._elites_dev = e_rows

        # publish the last generation's candidates (as _fused_step)
        remove_all_files_but(self.experiment.elite_dir(), [])
        self.elites_to_evaluate = []
        self._cand_thetas = {}
        for i in range(n_cands):
            path = self._elite_path_tpl.format(i=i)
            self.elites_to_evaluate.append((i, path))
            self._cand_thetas[path] = c_rows[i]
        self._cands_dev = c_rows
        self._cand_scores_pending = cand_all[b - 1]
        self._selected_dev = selected
        self._n_selected = S
        self.parents_mat = None
        self.policy_theta = policy
        elite_paths_next = [p for p, _ in it.best_elites() if p]
        self._parent_paths = elite_paths_next + [None] * S
        self._n_parents = len(elite_paths_next) + S

    def run_master(self, plot: bool = False,
                   max_iterations: int | None = None):
        config, it, stats = self.config, self.it, self.stats
        limit = max_iterations or config.max_nb_iterations
        L = self.exp["nb_offspring"]
        pop_size = self.experiment.population_size()
        num_elites = self.experiment.num_elites()
        n_cands = self.experiment.num_elite_cands()

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
                sampler = self._batch_sampler()

                if b > 1:
                    self._fused_block_step(b, t_block, sigma, bs, L,
                                           pop_size, num_elites, n_cands)
                else:
                    # per-generation steps read and rewrite the slot files:
                    # settle the block-merged rows first
                    self._materialize_podium()
                    idx_row = sampler.batch(bs)
                    step = (self._fused_step
                            if self._selected_dev is not None
                            and self._fused_capable()
                            else self._plain_step)
                    scores, best_ev_acc, norm = step(
                        idx_row, sigma, L, pop_size, num_elites, n_cands)
                    if it.patience_reached() or it.schedule_reached():
                        self._sampler = None
                    stats.record_score_stats(scores)
                    stats.record_bs_stats(it.batch_size())
                    stats.record_step_time_stats()
                    stats.record_norm_stats([norm])
                    stats.record_acc_stats(
                        best_ev_acc if best_ev_acc > float("-inf") else 0.0)
                    stats.record_best_acc_stats(it.best_elites()[0][1])
                    stats.record_std_stats(it.noise_stdev())
                    stats.update_mem_stats()
                    stats.log_stats()
                    it.log_stats()

                if config.snapshot_freq and \
                        it.iteration() % config.snapshot_freq == 0:
                    self._snapshot(plot)
                    self._last_snapshot_iter = it.iteration()
                if limit and it.iteration() >= limit:
                    break
                if it.patience_reached() or it.schedule_reached():
                    break

        self._profile_finalize()  # in case the run ended in its dispatch
        if self._last_snapshot_iter != it.iteration():
            self._snapshot(plot)
        return self.policy_theta

    # ---- checkpointing --------------------------------------------------------------

    def _write_parent_files(self) -> list:
        """The parent rows as .pth files for the z_info checkpoint: elites
        are files already; children come from the selected matrix (fused)
        or the parent matrix (plain), one pull each."""
        spec = self.task.spec
        parents, keep_files = [], []
        fused = self.parents_mat is None
        sel = self._selected_dev.cpu() if fused else None
        plain = (self.parents_mat.cpu()
                 if not fused and any(p is None for p in self._parent_paths)
                 else None)
        n_elite_rows = sum(1 for p in self._parent_paths if p is not None)
        for i in range(self._n_parents):
            path = self._parent_paths[i]
            if path is None:
                path = self._parent_path_tpl.format(i=i)
                spec.save_pth(sel[i - n_elite_rows] if fused else plain[i],
                              path)
            parents.append((i, path))
            if path.startswith(self.experiment.offspring_dir()):
                keep_files.append(path)
        remove_all_files_but(self.experiment.offspring_dir(), keep_files)
        return parents

    def _snapshot(self, plot: bool):
        self._materialize_podium()  # z_info references the slot files
        have_parents = (self.parents_mat is not None
                        or self._selected_dev is not None)
        for _, path in self.elites_to_evaluate:
            self._ensure_cand_file(path)
        parents = self._write_parent_files() if have_parents else []
        # ES checkpoint state (reference: nic_es/iteration.py:30-35)
        self.it.extra_state = {
            "elites_to_evaluate": list(self.elites_to_evaluate),
            "parents": parents,
        }
        save_snapshot(self.stats, self.it, self.experiment,
                      loader_state=self.loader_state())
        if plot:
            self.stats.plot_stats(self.experiment.snapshot_dir())
