"""Experiment configuration (port of ``nes_img_captioning_tpu/utils/config.py``).

The same experiment-JSON surface as the JAX package, so one file configures
either: one experiment JSON per run (reference: experiments/*.json), parsed
into a ``Config`` with the reference's field set
(src/algorithm/tools/utils.py:14-20); keys starting with ``_`` are disabled.
The execution section keeps its JSON name ``"tpu"`` and every knob of the
JAX package, so a file written for it parses here. The port reads
``precision``, ``delta_dtype``, ``kernel_perturb``, ``kernel_noise``,
``fused_decode``, ``device_cider``, ``decode_vocab_tile`` (validated when
the task is built: a multiple of 128 dividing the padded vocab),
``pop_chunk``, ``gens_per_dispatch``, ``val_freq``, ``fused_validation``
(true, false or "auto": validation and podium on the card inside each
block; "auto" turns it on when the run can fuse it and
``gens_per_dispatch`` > 1, as the JAX package resolves it), ``profile``
(a torch.profiler trace of generation 2, ``algorithms/master_base.py``),
``es_decode_layout`` (NIC-ES children built in decode order),
``mesh_shape`` (the ranks of a process group, ``parallel/``: its product
must be the group's size) and ``seed``; it accepts the others without
reading them yet. Unlike the JAX parser, ``kernel_noise``, ``fused_decode`` and
``device_cider`` are validated like the other tri-state knobs, so a
near-miss such as ``"false"`` is rejected instead of read as true.
``fused_decode`` and ``device_cider`` resolve when the captioning task is
built (``tasks/captioning.py``): "auto" as in the JAX package, and an
explicit true that the port cannot honour (the decode kernels for a norm
variant, the device scorer at V + 1 >= 16384) raises where the JAX
package goes on with another path; on the card the decode kernels take
E, R <= 512 (zero-padded to the next built width), so a wider no-norm
model raises unless ``fused_decode`` is false. ``rng_impl`` takes the names JAX's
``jax.random.key(..., impl=)`` takes (and "" for its default) and rejects
any other, as JAX does; the port draws from its own Philox stream whatever
it names (README, "Deviation: the noise stream"), which the masters log.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = ["Config", "TpuConfig", "parse_config", "parse_tpu_config",
           "load_experiment"]


@dataclasses.dataclass(frozen=True)
class Config:
    """Runtime loop knobs — field-for-field the reference Config namedtuple
    (src/algorithm/tools/utils.py:14-20); None means "not set"."""

    l2coeff: float | None = None
    noise_stdev: float | None = None
    stdev_divisor: float | None = None
    eval_prob: float | None = None
    snapshot_freq: int | None = None
    log_dir: str | None = None
    batch_size: int | None = None
    patience: int | None = None
    val_batch_size: int | None = None
    num_val_batches: int | None = None
    num_val_items: int | None = None
    cuda: bool | None = None  # accepted for config-file compat
    max_nb_iterations: int | None = None
    ref_batch_size: int | None = None
    bs_multiplier: float | None = None
    stepsize_divisor: float | None = None
    single_batch: bool | None = None
    schedule_limit: int | None = None
    schedule_start: int | None = None


@dataclasses.dataclass(frozen=True)
class TpuConfig:
    """Execution knobs (no reference counterpart), named as in the JAX
    package; see its utils/config.py for each knob's meaning."""

    pop_chunk: int = 0  # pairs per kernel launch; 0 = all pairs at once
    mesh_shape: tuple[int, ...] | None = None
    precision: str = "f32"  # rollout compute dtype: "f32" | "bf16"
    seed: int | None = None
    profile: bool = False
    fused_decode: object = "auto"  # fused decode kernels: "auto"|True|False
    val_freq: int = 1
    device_cider: object = "auto"  # CIDEr-D on the device: "auto"|True|False
    sensitivity_precision: str = "float32"
    sensitivity_batch: int = 0
    sensitivity_split: int = 100
    sensitivity_probes: int = 0
    decode_vocab_tile: int = 0  # vocab-tiled greedy decode K4; 0 = K1
    gens_per_dispatch: int = 1
    fused_es: object = "auto"
    fused_validation: object = "auto"  # on-card validation: "auto"|True|False
    es_decode_layout: object = "auto"
    kernel_perturb: object = "auto"  # pair kernel K2: "auto"|True|False
    kernel_noise: object = "auto"
    delta_dtype: str = "f32"  # storage dtype of the pair delta: f32 | bf16
    rng_impl: str = ""  # one of RNG_IMPLS; no port counterpart


# the PRNG implementations JAX's jax.random.key(seed, impl=) accepts; ""
# is its default (threefry2x32)
RNG_IMPLS = ("", "threefry2x32", "rbg", "unsafe_rbg")


def _strip_disabled(d: dict) -> dict:
    return {k: v for k, v in d.items() if not k.startswith("_")}


def parse_config(exp: dict) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = _strip_disabled(exp.get("config", {}))
    unknown = set(cfg) - known
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return Config(**cfg)


def _alias(cfg: dict, knob: str, aliases: dict):
    if knob in cfg:
        try:
            cfg[knob] = aliases[cfg[knob]]
        except KeyError:
            raise ValueError(f"tpu.{knob}={cfg[knob]!r}: expected one of "
                             f"{sorted(set(aliases))}") from None


def parse_tpu_config(exp: dict) -> TpuConfig:
    cfg = _strip_disabled(exp.get("tpu", {}))
    known = {f.name for f in dataclasses.fields(TpuConfig)}
    unknown = set(cfg) - known
    if unknown:
        raise ValueError(f"unknown tpu keys: {sorted(unknown)}")
    if cfg.get("mesh_shape") is not None:
        cfg["mesh_shape"] = tuple(cfg["mesh_shape"])
    _alias(cfg, "sensitivity_precision",
           {"f32": "float32", "bf16": "bfloat16", "float32": "float32",
            "bfloat16": "bfloat16"})
    _alias(cfg, "delta_dtype", {"f32": "f32", "float32": "f32",
                                "bf16": "bf16", "bfloat16": "bf16"})
    _alias(cfg, "precision", {"f32": "f32", "float32": "f32",
                              "bf16": "bf16", "bfloat16": "bf16"})
    if cfg.get("rng_impl", "") not in RNG_IMPLS:
        raise ValueError(
            f"tpu.rng_impl={cfg['rng_impl']!r}: unrecognized PRNG "
            f"implementation, expected one of {list(RNG_IMPLS)}")
    if cfg.get("sensitivity_probes") is not None \
            and int(cfg["sensitivity_probes"]) < 0:
        raise ValueError(
            f"tpu.sensitivity_probes={cfg['sensitivity_probes']!r}: "
            "expected 0 (exact) or a positive probe count")
    for knob in ("fused_es", "fused_validation", "es_decode_layout",
                 "kernel_perturb", "kernel_noise", "fused_decode",
                 "device_cider"):
        # identity checks: `0 in (True, False)` would be truthy
        if knob in cfg and not (
            cfg[knob] is True or cfg[knob] is False or cfg[knob] == "auto"
        ):
            raise ValueError(f"tpu.{knob}={cfg[knob]!r}: expected true, "
                             "false, or \"auto\"")
    return TpuConfig(**cfg)


def load_experiment(path_or_dict: str | dict[str, Any]) -> dict[str, Any]:
    """Load an experiment JSON and strip ``_``-disabled keys (top level and
    inside ``config``)."""
    if isinstance(path_or_dict, dict):
        exp = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            exp = json.load(f)
    exp = _strip_disabled(exp)
    if "config" in exp:
        exp["config"] = _strip_disabled(exp["config"])
    return exp
