"""Task interface consumed by the engines (port of ``nes_img_captioning_tpu/tasks/base.py``).

A task owns the model family (param spec), the device-resident dataset, the
fitness definition and validation scoring — the split of the reference's
Policy/Experiment plugins (src/algorithm/policies.py:44-172).
"""

from __future__ import annotations

import abc

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
