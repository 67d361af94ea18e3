"""Task plugins (port of ``nes_img_captioning_tpu/tasks/__init__.py``):
dataset + net + fitness (reference registry: src/algorithm/policies.py:16-29).
"""

from .base import Task

__all__ = ["Task", "make_task"]


def make_task(exp: dict, config, tpu_cfg, device=None, data=None) -> Task:
    """The task of ``exp["dataset"]`` on ``device`` (default: the card).
    ``data`` hands an in-memory dataset to the task instead of the files its
    options name: a CocoData for mscoco, ``load_mnist``'s arrays for
    mnist."""
    dataset = exp["dataset"]
    if dataset == "mnist":
        from .classification import MnistTask

        return MnistTask(exp, config, tpu_cfg, device=device, data=data)
    if dataset == "mscoco":
        from .captioning import CocoTask

        return CocoTask(exp, config, tpu_cfg, device=device, data=data)
    raise ValueError(f"unsupported dataset {dataset!r}")
