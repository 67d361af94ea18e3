"""What the NES and ES training loops share (``NESMaster``, ``ESMaster``):
the experiment's parse and refusals, the process group, the task, the host
RNG and its batch sampler, a resume from a z_info file, the podium's
deferred slot files and the cadence of a block of chained generations, and
``tpu.profile``'s trace.

The snapshot's loader sidecar carries the seed stream's position
(``seed_rng_state``) beside the sampler's, so a resumed run continues the
seeds as well as the batches. The JAX package's sidecar holds only the
sampler, and its resumed run draws the seeds of generation 1 again.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import shutil
import tempfile

import numpy as np
import torch

from .iteration import Iteration
from .snapshot import load_loader_state
from .statistics import Statistics
from ..data.core import build_sampler
from ..ops.mutation import MutationKind
from ..parallel.mesh import make_mesh, pop_axis_size
from ..ops.sensitivity import (
    load_sensitivity_file,
    sm_vector_normalize,
    subsample_batch_rows,
)
from ..utils.config import parse_config, parse_tpu_config
from ..utils.files import mkdir_p

logger = logging.getLogger(__name__)

__all__ = ["MasterBase", "setup_log_dir"]


def setup_log_dir(exp: dict, primary: bool = True) -> str:
    """logs/{algo}_{dataset}_{net}_{pid} unless the experiment names one
    (reference: tools/setup.py:22-25). A non-primary rank keeps its whole
    bookkeeping in a private scratch directory, removed when the process
    exits: its host logic (podium files, model writes, snapshots) stays the
    primary's bit for bit, and only the primary's directory holds the run's
    artifacts (JAX: nes.py:662-684)."""
    if primary:
        log_dir = exp.get("log_dir") or "logs/{}_{}_{}_{}".format(
            exp["algorithm"], exp["dataset"], exp["policy_options"]["net"],
            os.getpid())
        mkdir_p(log_dir)
    else:
        log_dir = tempfile.mkdtemp(prefix="nes_replica_logdir_")
        atexit.register(shutil.rmtree, log_dir, ignore_errors=True)
    exp["log_dir"] = log_dir
    return log_dir


class MasterBase:
    """One process on one card, or one rank of a process group
    (``parallel/``): every rank runs the whole loop on the same draws and
    sweeps its shard of the population. A subclass sets
    ``self.experiment`` before a resume and keeps the podium's device rows
    in ``self._elites_dev``."""

    def __init__(self, exp: dict, device=None, data=None, mesh=None):
        """``device``: the card unless ``"cpu"`` is passed (a rank's own
        card in a group: ``RankGroup.device``); ``data``: the task's
        in-memory data instead of its files (``make_task``: a CocoData, or
        ``load_mnist``'s arrays); ``mesh``: this rank's ``RankGroup``, by
        default the process's (``parallel.make_mesh``). ``tpu.mesh_shape``
        must hold as many ranks as the group, and a group needs
        ``tpu.seed``."""
        from ..tasks import make_task

        self.exp = exp
        self.config = parse_config(exp)
        self.tpu_cfg = tpu = parse_tpu_config(exp)
        self.mesh = mesh if mesh is not None else make_mesh()
        world = pop_axis_size(self.mesh)
        if tpu.mesh_shape is not None and int(np.prod(tpu.mesh_shape)) \
                != world:
            n = int(np.prod(tpu.mesh_shape))
            raise ValueError(
                f"tpu.mesh_shape {list(tpu.mesh_shape)} holds {n} ranks and "
                f"this process is one of {world}: start the run with "
                f"nes_img_captioning_tpu_torch/main.py, which starts {n} "
                f"local ranks, or with --num_processes {n} on each")
        if self.mesh is not None and tpu.seed is None:
            raise ValueError(
                "a process group needs tpu.seed: every rank must draw the "
                "same seeds and batches")
        if self.mesh is not None and device is None:
            device = self.mesh.device
        popts = exp.get("policy_options", {})
        mopts = popts.get("model_options", {})
        self.mutation = MutationKind(mopts.get("safe_mutations", "") or "")
        # the safe kinds' clamp (reference: safe_mutations.py:28-32,62-63)
        self._underflow = float(mopts.get("safe_mutation_underflow", 0.01))
        setup_log_dir(exp, primary=self.mesh is None or self.mesh.rank == 0)
        if tpu.rng_impl:
            logger.warning(
                "tpu.rng_impl=%r has no counterpart in the port: every "
                "stream is the port's own (Philox per seed, torch "
                "generators; README, \"Deviation: the noise stream\")",
                tpu.rng_impl)

        self.task = make_task(exp, self.config, tpu, device=device,
                              data=data)
        self.device = self.task.device
        self.it = Iteration(self.config, exp)
        self.stats = Statistics()
        self._rng = np.random.default_rng(tpu.seed)
        self._sampler = None  # built lazily; rebuilt on annealing
        self._pending_loader_state = None  # set by a from_infos resume
        self._elites_dev = None  # the device podium's rows
        self._podium_dirty = False  # slot files behind the adopted scores
        self._block_warned = False
        self._last_snapshot_iter = None
        self._profiler = None  # tpu.profile's running trace
        # SM-VECTOR's precomputed sensitivity, normalized, on the device
        self._sens_vector = None
        if self.mutation is MutationKind.SAFE_VECTOR:
            self._sens_vector = self._place_sens(load_sensitivity_file(
                mopts["safe_mutation_vector"]), self._underflow)

    def _place_sens(self, vector, underflow: float) -> torch.Tensor:
        """An SM-VECTOR vector clamped at ``underflow`` and divided by its
        min (``sm_vector_normalize``), as a (dim,) f32 tensor on the
        device."""
        return torch.as_tensor(sm_vector_normalize(vector, underflow)
                               ).to(self.device)

    def _sens_batch_rows(self, idx_row) -> np.ndarray:
        """SM-G's batch rows: the first ``tpu.sensitivity_batch`` of a
        generation's batch (all for 0)."""
        return subsample_batch_rows(idx_row, self.tpu_cfg.sensitivity_batch)

    def _resume(self, infos_path: str) -> dict:
        """Load a z_info file into the statistics, the iteration and the
        experiment; the sampler resumes at the first batch draw and the
        seed stream at once. Returns the infos."""
        with open(infos_path) as f:
            infos = json.load(f)
        self.stats.init_from_infos(infos)
        self.it.init_from_infos(infos)
        self.experiment.init_from_infos(infos)
        self._pending_loader_state = load_loader_state(infos_path)
        if self._pending_loader_state and \
                "seed_rng_state" in self._pending_loader_state:
            self._rng.bit_generator.state = \
                self._pending_loader_state["seed_rng_state"]
        return infos

    def _batch_sampler(self):
        """The epoch sampler, built at the first draw (from the resumed
        position, if any)."""
        if self._sampler is None:
            self._sampler = build_sampler(self.task.train_n, self._rng,
                                          self._pending_loader_state)
            self._pending_loader_state = None  # anneal rebuilds start fresh
        return self._sampler

    def loader_state(self) -> dict | None:
        """The batch sampler's and the seed stream's positions for the
        snapshot sidecar (None before the first batch draw). The JAX
        package reads the sampler's keys and ignores the other."""
        if self._sampler is None:
            return None
        return {**self._sampler.state_dict(),
                "seed_rng_state": self._rng.bit_generator.state}

    def _materialize_podium(self):
        """Write the slot files of the scores adopted from a device merge:
        pull the podium's rows once and install them. Runs before anything
        reads the slot files (a snapshot, a host step)."""
        if not self._podium_dirty:
            return
        scores = [s for _, s in self.it.best_elites() if np.isfinite(s)]
        rows = self._elites_dev.cpu()
        self.it.install_merged_podium(
            scores, rows, lambda row, path: self.task.spec.save_pth(row, path))
        self._podium_dirty = False

    # ---- tpu.profile -----------------------------------------------------

    def _profile_hook(self, first: int, gens: int):
        """With ``tpu.profile``, trace the dispatch of generations
        ``first`` .. ``first + gens - 1`` with torch.profiler if it runs
        generation 2 (CUDA and CPU activities on the card, CPU alone on the
        CPU); a dispatch after it writes the trace (``_profile_finalize``).
        The JAX package starts its trace only when a dispatch begins at
        generation 2, so in blocks of 2 or more it traces nothing; here a
        block that holds generation 2 is traced whole."""
        if not self.tpu_cfg.profile:
            return
        if self._profiler is None and first <= 2 < first + gens:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
        elif first > 2:
            self._profile_finalize()

    def _profile_finalize(self):
        """Stop a running trace and write it as a Chrome trace,
        ``<log_dir>/profile/trace_<pid>.pt.trace.json`` (read by
        ``utils/profile_summary``); called again at the end of the run, in
        case it ended in the traced dispatch."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        path = os.path.join(mkdir_p(os.path.join(self.exp["log_dir"],
                                                 "profile")),
                            f"trace_{os.getpid()}.pt.trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info("wrote the torch.profiler trace of generation 2: %s",
                    path)

    # ---- the cadence of a block (tpu.gens_per_dispatch) ---------------------

    @staticmethod
    def _gap_to_next(cur_plus1: int, freq: int, start: int = 0) -> int:
        """Iterations from cur_plus1 (exclusive of events AT cur_plus1) to
        the next multiple-of-freq event after it."""
        if not freq:
            return 1 << 30
        j = max(cur_plus1 + 1, start)
        rem = (j - start) % freq
        return (j + (freq - rem) % freq) - cur_plus1

    def _chain_gap(self, nxt: int) -> int:
        """The most generations from iteration ``nxt`` on that the
        algorithm's own state lets one block hold (1: run it alone)."""
        return 1 << 30

    def _block_budget(self, gens_left: int, limit: int | None) -> int:
        """Generations chained into the next block. A block never contains
        an interior schedule firing or snapshot, nor whatever ``_chain_gap``
        keeps out of it; its size is rounded down to a power of two, as in
        the JAX package, so both packages run the same blocks."""
        b = max(self.tpu_cfg.gens_per_dispatch, 1)
        if b == 1:
            return 1
        if self.config.patience:
            if not self._block_warned:
                self._block_warned = True  # once, not every iteration
                logger.warning(
                    "gens_per_dispatch>1 requires patience=0 (patience may "
                    "anneal sigma mid-block); driving per-generation")
            return 1
        nxt = self.it.iteration() + 1  # the block's first iteration
        cap = self._chain_gap(nxt)
        if cap <= 1:
            return 1
        gap, start = self._gap_to_next, self.config.schedule_start or 0
        if self.config.schedule_limit and gap(
                nxt - 1, self.config.schedule_limit, start) == 1:
            return 1  # this iteration fires the schedule: run it alone
        b = min(b, gens_left, cap)
        if limit:
            b = min(b, limit - self.it.iteration())
        if self.config.schedule_limit:
            b = min(b, gap(nxt, self.config.schedule_limit, start))
        if self.config.snapshot_freq:
            # a snapshot writes the state after its generation: end the
            # block exactly on the snapshot iteration
            b = min(b, gap(nxt - 1, self.config.snapshot_freq))
        b = max(b, 1)
        return 1 << (b.bit_length() - 1)
