"""Task interface consumed by the engines (port of ``nes_img_captioning_tpu/tasks/base.py``).

A task owns the model family (param spec), the device-resident dataset, the
fitness definition and validation scoring — the split of the reference's
Policy/Experiment plugins (src/algorithm/policies.py:44-172).
"""

from __future__ import annotations

import abc
import contextlib

import numpy as np
import torch

__all__ = ["Task"]


class Task(abc.ABC):
    #: True when the rollouts already return the scalar fitness on device
    artifact_is_fitness: bool = True

    #: model family object exposing .spec (ParamSpec)
    model = None

    @property
    def fitness_on_device(self) -> bool:
        return self.artifact_is_fitness

    @property
    def spec(self):
        return self.model.spec

    @property
    @abc.abstractmethod
    def train_n(self) -> int:
        """Number of training items."""

    def device_consts(self) -> dict:
        """Device-resident tensors the rollouts read (datasets, scorer
        tables), handed back through ``consts=``."""
        return {}

    def generate_theta(self, generator):
        """Random individual, reference init rules, on the generator's
        device."""
        return self.spec.init_theta(generator)

    def numerics(self):
        """The context the task's products run in, entered by the rollouts
        and by the sensitivity sweeps (forward and pullbacks): by default
        the process's own settings."""
        return contextlib.nullcontext()

    def test_score(self, theta) -> float:
        """Test-set score (offline eval); a task with a test split
        overrides it (JAX: tasks/base.py:104-106)."""
        raise NotImplementedError

    def host_fitness(self, artifacts, idx) -> np.ndarray:
        """The fitness array of a sweep's artifacts: the device scorer's
        ``{"fitness": ...}`` passes through. A task whose rollouts return
        other artifacts (``CocoTask``'s tokens) scores them in its own
        override (JAX: captioning.py:528-573)."""
        if isinstance(artifacts, dict) and "fitness" in artifacts:
            f = artifacts["fitness"]
            f = f.detach().cpu().numpy() if torch.is_tensor(f) else f
            return np.asarray(f, np.float32)
        raise TypeError(f"{type(self).__name__} rollouts returned no "
                        "fitness and the task scores no other artifact")
