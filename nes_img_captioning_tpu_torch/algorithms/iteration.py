"""Generation bookkeeping: counters, the two annealing triggers, and the
podium handoff (a copy of ``nes_img_captioning_tpu/algorithms/iteration.py``).

Behavioral spec (reference: src/algorithm/tools/iteration.py — reimplemented
against the z_info schema, not transcribed). Two independent triggers can
fire a curriculum step (sigma /= stdev_divisor, batch_size *= bs_multiplier):

* **patience** — more than ``patience`` consecutive generations without a
  podium improvement;
* **schedule** — a fixed cadence: every ``schedule_limit`` iterations once
  ``schedule_start`` has passed, evaluated when the iteration counter
  advances.

The reference's Redis result-counting surface (models_left_to_evolve etc.)
has no counterpart here: one SPMD program returns the whole generation at
once, so the only per-iteration state left is the elite-eval scoreboard.
"""

from __future__ import annotations

import logging
import os

from .podium import Podium
from ..utils.config import Config
from ..utils.files import mkdir_p
from ..utils.logger import log

logger = logging.getLogger(__name__)

__all__ = ["Iteration"]


class _Curriculum:
    """The annealable pair (noise stdev, batch size) plus its step rule."""

    def __init__(self, config: Config):
        self.noise_stdev = config.noise_stdev
        self.batch_size = config.batch_size
        self.times_orig_bs = 1
        self._stdev_divisor = config.stdev_divisor
        self._bs_multiplier = config.bs_multiplier

    def step(self, trigger: str):
        logger.warning(
            "curriculum step (%s trigger): sigma %s -> %s, batch size %s -> %s",
            trigger,
            self.noise_stdev, self.noise_stdev / self._stdev_divisor,
            self.batch_size, int(self.batch_size * self._bs_multiplier),
        )
        self.noise_stdev /= self._stdev_divisor
        self.batch_size = int(self.batch_size * self._bs_multiplier)
        self.times_orig_bs *= self._bs_multiplier


class Iteration:
    def __init__(self, config: Config, exp: dict):
        self._curriculum = _Curriculum(config)
        self._patience = config.patience
        self._schedule_limit = config.schedule_limit
        self._schedule_start = config.schedule_start or 0

        self._epoch = 0
        self._iteration = 0
        self._nb_samples_used = 0
        self._generations_without_improvement = 0
        self._nb_offspring = exp["nb_offspring"]

        # which trigger fired THIS iteration (read by the training loop to
        # rebuild samplers/loaders at the new batch size)
        self._fired_patience = False
        self._fired_schedule = False

        if int(exp["num_elites"]) < 1:
            # both masters read best_elites()[0] for the per-generation
            # BestEliteAcc stat (as the reference does unconditionally —
            # src/algorithm/tools/iteration.py:52-62); a 0-capacity podium
            # would fail there on generation 1, so reject it up front
            raise ValueError(
                f"num_elites={exp['num_elites']}: the podium needs at least "
                "one slot (reference semantics; use num_elites >= 1)"
            )
        self._log_dir = exp["log_dir"]
        self._models_dir = mkdir_p(os.path.join(self._log_dir, "models"))
        self._podium = Podium(
            config.patience,
            os.path.join(self._models_dir, "best"),
            num_elites=exp["num_elites"],
        )

        # this iteration's elite evaluations: cand_id -> (path, best score)
        self._eval_results: dict = {}

        # algorithm-specific checkpoint state merged into to_dict()
        # (NES: current_model; ES: parents + elites_to_evaluate)
        self.extra_state: dict = {}

    # ---- checkpoint (z_info schema — key names are the public surface) --------

    def to_dict(self) -> dict:
        return {
            "iter": self._iteration,
            "epoch": self._epoch,
            "noise_stdev": self._curriculum.noise_stdev,
            "batch_size": self._curriculum.batch_size,
            "bad_generations": self._generations_without_improvement,
            "times_orig_bs": self._curriculum.times_orig_bs,
            "nb_samples_used": self._nb_samples_used,
            # only the filled slots: the z_info schema stores real files
            "best_elites": [e for e in self.best_elites() if e[0]],
            **self.extra_state,
        }

    def init_from_infos(self, infos: dict):
        # counters were written post-increment, so rewind one step: the
        # first incr of the resumed run lands back on the recorded values
        if "epoch" in infos:
            self._epoch = infos["epoch"] - 1
        if "iter" in infos:
            self._iteration = infos["iter"] - 1
        self._generations_without_improvement = infos.get(
            "bad_generations", self._generations_without_improvement
        )
        cur = self._curriculum
        cur.noise_stdev = infos.get("noise_stdev", cur.noise_stdev)
        cur.batch_size = infos.get("batch_size", cur.batch_size)
        cur.times_orig_bs = infos.get("times_orig_bs", cur.times_orig_bs)
        self._nb_samples_used = infos.get(
            "nb_samples_used", self._nb_samples_used
        )
        self._podium.init_from_infos(infos)

    # ---- counter advancement + schedule trigger -----------------------------------

    def incr_epoch(self):
        self._epoch += 1

    def incr_iteration(self):
        self._eval_results = {}
        self._fired_patience = False
        self._fired_schedule = False
        self._iteration += 1
        self._nb_samples_used += self._curriculum.batch_size

        if self.check_schedule_limit():
            self._fired_schedule = True
            self._curriculum.step("schedule")

    def check_schedule_limit(self) -> bool:
        if not self._schedule_limit or self._iteration < self._schedule_start:
            return False
        return (self._iteration - self._schedule_start) % self._schedule_limit == 0

    def next_curriculum_step(self):
        self._curriculum.step("manual")

    # ---- elite evals + patience trigger -------------------------------------------

    def record_eval_result(self, cand_id, cand_path: str, score: float):
        """Scoreboard entry per candidate id; repeated evals keep the max
        (reference max-merge semantics)."""
        incumbent = self._eval_results.get(cand_id)
        if incumbent is not None and incumbent[1] is not None:
            score = max(score, incumbent[1])
        self._eval_results[cand_id] = (cand_path, score)

    def eval_results(self):
        return self._eval_results

    def process_evaluated_elites(self):
        """Feed this generation's elite evaluations to the podium, then run
        the patience trigger. Returns (best score, best path) among the
        candidates whose files still exist."""
        candidates = [
            (path, score)
            for path, score in self._eval_results.values()
            if os.path.isfile(path)
        ]
        self._podium.record_elites(candidates)

        if self._patience and self._podium.is_bad_generation():
            self._generations_without_improvement += 1
            if self._generations_without_improvement > self._patience:
                self._fired_patience = True
                self._curriculum.step("patience")
                self._generations_without_improvement = 0
        else:
            self._generations_without_improvement = 0

        if not candidates:
            return float("-inf"), None
        best_path, best_score = max(candidates, key=lambda c: c[1])
        return best_score, best_path

    # ---- logging -----------------------------------------------------------------

    def log_stats(self):
        log("NoiseStd", self._curriculum.noise_stdev)
        log("BatchSize", self._curriculum.batch_size)
        log("NbSamplesUsed", self._nb_samples_used)
        if self._patience:
            log("BadGen",
                f"{self._generations_without_improvement}/{self._patience}")
        elif self._schedule_limit:
            # progress toward the next schedule firing (the first firing
            # waits for schedule_start)
            if self._iteration <= self._schedule_start:
                done, period = self._iteration, self._schedule_start
            else:
                done = (self._iteration - self._schedule_start) % self._schedule_limit
                period = self._schedule_limit
            log("Schedule", f"{done}/{period}")

    # ---- accessors --------------------------------------------------------------

    def patience_reached(self):
        return self._fired_patience

    def schedule_reached(self):
        return self._fired_schedule

    def epoch(self):
        return self._epoch

    def iteration(self):
        return self._iteration

    def noise_stdev(self):
        return self._curriculum.noise_stdev

    get_noise_stdev = noise_stdev

    def batch_size(self):
        return self._curriculum.batch_size

    def times_orig_bs(self):
        return self._curriculum.times_orig_bs

    def nb_samples_used(self):
        return self._nb_samples_used

    def nb_offspring(self):
        return self._nb_offspring

    def models_dir(self):
        return self._models_dir

    def best_elites(self):
        return self._podium.best_elites()

    def install_merged_podium(self, scores, rows, save_row):
        """ES blocked path: adopt the device-merged scoreboard (see
        Podium.install_merged)."""
        self._podium.install_merged(scores, rows, save_row)

    def adopt_merged_scores(self, scores):
        """ES blocked path: adopt merged slot scores, file writes deferred
        (see Podium.adopt_scores)."""
        self._podium.adopt_scores(scores)

    def best_elite(self):
        return self._podium.best_elites()[0][0]
