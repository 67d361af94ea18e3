"""Experiment-wide bookkeeping: log/snapshot dirs, checkpoint dict, optimizer
ownership for NES (reference: src/algorithm/tools/experiment.py,
src/algorithm/nic_nes/experiment.py, src/algorithm/nic_es/experiment.py).

Dataloader construction lives in the Task; this class only tracks the
loader-derived counters that go into the z_info checkpoint
(trainloader_lth, orig_bs). Port of
``nes_img_captioning_tpu/algorithms/experiment.py``.
"""

from __future__ import annotations

import json
import os

from .optimizers import make_optimizer
from ..utils.config import Config
from ..utils.files import mkdir_p

__all__ = ["Experiment", "NESExperiment", "ESExperiment"]


class Experiment:
    def __init__(self, exp: dict, config: Config, task, master: bool = True):
        self._exp = exp
        self._dataset = exp["dataset"]
        self._algorithm = exp["algorithm"]
        self._nb_offspring = exp["nb_offspring"]
        self._orig_bs = config.batch_size
        self._orig_trainloader_lth = max(task.train_n // config.batch_size, 1)
        self._master = master
        if master:
            self._log_dir = exp["log_dir"]
            self._snapshot_dir = os.path.join(self._log_dir, "snapshot")
            mkdir_p(self._snapshot_dir)
            with open(os.path.join(self._snapshot_dir, "experiment.json"), "w") as f:
                json.dump(exp, f)

    def to_dict(self) -> dict:
        return {
            "trainloader_lth": self._orig_trainloader_lth,
            "algorithm": self._algorithm,
            "orig_bs": self._orig_bs,
        }

    def init_from_infos(self, infos: dict):
        self._orig_bs = infos.get("orig_bs", self._orig_bs)
        self._orig_trainloader_lth = infos.get(
            "trainloader_lth", self._orig_trainloader_lth
        )
        self._algorithm = infos.get("algorithm", self._algorithm)

    def nb_offspring(self):
        return self._nb_offspring

    def orig_trainloader_lth(self):
        return self._orig_trainloader_lth

    def orig_batch_size(self):
        return self._orig_bs

    def log_dir(self):
        assert self._master
        return self._log_dir

    def snapshot_dir(self):
        assert self._master
        return self._snapshot_dir


class NESExperiment(Experiment):
    """Owns the theta optimizer + its .tar persistence
    (reference: src/algorithm/nic_nes/experiment.py)."""

    def __init__(self, exp, config, task, master=True):
        super().__init__(exp, config, task, master)
        self.optimizer = make_optimizer(exp["optimizer_options"])
        self.opt_state = None  # device OptState, set by the master
        self._device = task.device
        if master:
            mkdir_p(os.path.join(self.log_dir(), "optimizer"))
            self.optimizer_path = os.path.join(
                self.log_dir(), "optimizer", "optimizer.tar"
            )

    def init_from_infos(self, infos: dict):
        super().init_from_infos(infos)
        if infos.get("optimizer_state"):
            self.opt_state = self.optimizer.load_from_file(
                infos["optimizer_state"], self._device)

    def to_dict(self) -> dict:
        dim = int(self.opt_state.v.shape[0]) if self.opt_state is not None else 0
        if self.opt_state is not None:
            self.optimizer.save_to_file(self.opt_state, dim, self.optimizer_path)
        return {**super().to_dict(), "optimizer_state": self.optimizer_path}


class ESExperiment(Experiment):
    """Population hyperparameters + model dirs
    (reference: src/algorithm/nic_es/experiment.py)."""

    def __init__(self, exp, config, task, master=True):
        super().__init__(exp, config, task, master)
        self._population_size = exp.get("population_size", exp["nb_offspring"])
        self._num_elites = exp["num_elites"]
        self._num_elite_cands = exp["num_elite_cands"]
        self._tournament_size = exp.get("tournament_size")
        self._selection = exp.get("selection", "uniform")
        if master:
            models = os.path.join(self._log_dir, "models")
            self._parents_dir = mkdir_p(os.path.join(models, "parents"))
            self._offspring_dir = mkdir_p(os.path.join(models, "offspring"))
            self._elite_dir = mkdir_p(os.path.join(models, "elite"))

    def population_size(self):
        return self._population_size

    def num_elites(self):
        return self._num_elites

    def num_elite_cands(self):
        return self._num_elite_cands

    def selection(self):
        return self._selection

    def tournament_size(self):
        return self._tournament_size

    def offspring_dir(self):
        return self._offspring_dir

    def elite_dir(self):
        return self._elite_dir
