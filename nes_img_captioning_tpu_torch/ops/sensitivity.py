"""Safe-mutation sensitivities, SM-G-SUM and SM-G-ABS (port of
``nes_img_captioning_tpu/ops/sensitivity.py``).

Reference semantics (src/algorithm/safe_mutations.py, from
uber-research/safemutations):

* SM-G-SUM: one forward through the task's ``sensitivity_forward`` giving a
  (B, K) output; Jacobian rows J_k = d(sum_b out[b, k]) / d theta;
  sensitivity = sqrt(sum_k J_k^2) / B (safe_mutations.py:103-117);
* SM-G-ABS: per-sample Jacobians, |J| averaged over the batch before the
  square root of the sum of squares (safe_mutations.py:119-146);
* post-processing: clamp below at ``underflow``, then divide by it
  (safe_mutations.py:62-63).

The Jacobian is ``torch.func.vjp`` of a pure function of the flat theta,
pulled back along the K one-hot rows at once with ``torch.func.vmap``.
``calc_sensitivities`` sweeps parents in groups of a fixed size under an
outer ``vmap``, so a row's bits depend on that row and the batch only: not
on how many parents are swept with it, nor on which path asks.

``precision`` (``tpu.sensitivity_precision``): "float32" runs the products
in f32 (with TF32 off, which is torch's default for matmul); "bfloat16"
runs the forward and the pullback under ``torch.autocast`` to bf16, whose
products take bf16 operands and accumulate in f32. The reductions and the
Jacobian itself stay f32. SM-G-ABS always runs f32, as in the JAX package.

The probe estimator (``tpu.sensitivity_probes``) takes its Rademacher
matrix as an operand. ``probe_matrix`` draws the port's own on the host:
a numpy generator seeded with the pair (the generation's member-0 seed,
``PROBE_FOLD``), so the matrix is the same on every device and path. It
differs from the JAX package's ``fold_in(key(seed), PROBE_FOLD)`` stream, a
deviation of the same class as the mutation noise's (``ops/mutation.py``).
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from .mutation import MutationKind

__all__ = ["PROBE_FOLD", "SENS_GROUP", "abs_sens", "calc_sensitivities",
           "calc_sensitivity", "load_sensitivity_file", "postprocess",
           "probe_matrix", "resolve_probes", "sm_vector_normalize",
           "subsample_batch_rows", "sum_sens", "sum_sens_probes"]

# parents per vmap of calc_sensitivities: a fixed count, so every group has
# the same shapes (at fc_caption's 2,865,808 parameters and split 400 a
# group's Jacobians take 1.4 GB)
SENS_GROUP = 5

# the probe stream's tag beside the generation's member-0 seed (the JAX
# package folds the same constant into that seed's key)
PROBE_FOLD = 0x50524245  # "PRBE"


def resolve_probes(mutation, probes: int) -> int:
    """Probe-count eligibility shared by both engines: the randomized
    estimator applies to SM-G-SUM only (the ABS path's per-sample |J|
    average has no column-norm identity), so SM-G-ABS runs exact with a
    one-time warning."""
    probes = int(probes)
    if probes and mutation is MutationKind.SAFE_GRAD_ABS:
        logging.getLogger(__name__).warning(
            "tpu.sensitivity_probes applies to SM-G-SUM only (the ABS "
            "path's per-sample |J| average has no column-norm identity); "
            "SM-G-ABS runs exact")
        return 0
    return probes


def sm_vector_normalize(vector, underflow: float) -> np.ndarray:
    """SM-VECTOR load-path normalization, shared by both masters: clamp
    below at ``underflow`` then divide by the min (reference:
    safe_mutations.py:28-32 — the vector path min-normalizes where the SM-G
    path divides by the underflow)."""
    v = np.maximum(np.asarray(vector, np.float32), underflow)
    return v / v.min()


def subsample_batch_rows(idx_row, k: int) -> np.ndarray:
    """The ``tpu.sensitivity_batch`` cost lever, shared by both masters:
    the Jacobian over the first ``k`` rows of the generation's batch (0 =
    the full batch, reference parity)."""
    idx_s = np.asarray(idx_row, np.int32)
    if k:
        idx_s = idx_s[: min(k, idx_s.shape[0])]
    return idx_s


def load_sensitivity_file(path: str) -> np.ndarray:
    """A precomputed SM-VECTOR sensitivity: a ``.npy`` array or a ``.pt``
    torch tensor (reference: safe_mutations.py:28-32)."""
    if path.endswith(".npy"):
        return np.load(path)
    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t.detach().numpy() if torch.is_tensor(t) else t)


def postprocess(sens: torch.Tensor, underflow: float) -> torch.Tensor:
    """Reference post-processing (safe_mutations.py:62-63): clamp below at
    ``underflow`` then divide by it."""
    return sens.clamp_min(underflow) / underflow


def probe_matrix(seed0: int, probes: int, groups: int) -> torch.Tensor:
    """The port's (probes, groups) f32 Rademacher matrix of one generation,
    on the CPU: entries -1 or +1 from a numpy generator seeded with
    (``seed0``, ``PROBE_FOLD``), ``seed0`` the generation's member-0
    seed."""
    rng = np.random.default_rng([int(seed0), PROBE_FOLD])
    bits = rng.integers(0, 2, size=(int(probes), int(groups)))
    return torch.from_numpy((2 * bits - 1).astype(np.float32))


def _products(precision: str, device):
    """The context of the sweep's products (see the module docstring)."""
    if precision == "bfloat16":
        return torch.autocast(torch.device(device).type, torch.bfloat16)
    if precision != "float32":
        raise ValueError(f"sensitivity precision {precision!r}: expected "
                         "'float32' or 'bfloat16'")
    return contextlib.nullcontext()


def _pullbacks(fn, theta, rows=None) -> torch.Tensor:
    """(R, dim) f32 pullbacks of ``fn`` (theta -> (K,)) at ``theta`` along
    ``rows`` (R, K); the Jacobian (K, dim) when ``rows`` is None."""
    out, pullback = torch.func.vjp(fn, theta)
    if rows is None:
        rows = torch.eye(out.shape[0], dtype=out.dtype, device=out.device)
    (J,) = torch.func.vmap(pullback)(rows.to(out.dtype))
    return J.to(torch.float32)


def sum_sens(forward, theta, idx, consts, precision: str = "float32"
             ) -> torch.Tensor:
    """SM-G-SUM of one flat theta before post-processing: sqrt(sum_k
    J_k^2) / B over the Jacobian of ``forward(theta, idx, consts).sum(0)``
    (JAX: sum_sens_traced)."""
    with _products(precision, theta.device):
        J = _pullbacks(lambda th: forward(th, idx, consts).sum(0), theta)
    return torch.linalg.vector_norm(J, dim=0) / idx.shape[0]


def sum_sens_probes(forward, theta, idx, consts, probes: torch.Tensor,
                    precision: str = "float32") -> torch.Tensor:
    """The randomized SM-G-SUM of one flat theta before post-processing:
    sqrt(mean_r (v_r^T J)^2) / B for the (R, K) Rademacher rows ``probes``,
    one forward and R pullbacks (JAX: sum_sens_probes_traced). Unbiased for
    the squared sensitivity; per-coordinate relative std <= 1/sqrt(2R)."""
    with _products(precision, theta.device):
        y = _pullbacks(lambda th: forward(th, idx, consts).sum(0), theta,
                       probes)
    return torch.sqrt((y ** 2).mean(0)) / idx.shape[0]


def abs_sens(forward, theta, idx, consts) -> torch.Tensor:
    """SM-G-ABS of one flat theta before post-processing: the per-sample
    Jacobians' |J| summed over the batch in row order, then sqrt(sum_k
    (acc_k / B)^2) (JAX: _abs_sens_scan). f32 throughout."""
    acc = None
    for i in range(idx.shape[0]):
        J = _pullbacks(lambda th: forward(th, idx[i:i + 1], consts)[0],
                       theta).abs()
        acc = J if acc is None else acc + J
    return torch.sqrt(((acc / idx.shape[0]) ** 2).sum(0))


def _raw(task, theta, idx, kind, precision, probes):
    forward, consts = task.sensitivity_forward, task.device_consts()
    if kind is MutationKind.SAFE_GRAD_SUM:
        if probes is not None:
            return sum_sens_probes(forward, theta, idx, consts, probes,
                                   precision)
        return sum_sens(forward, theta, idx, consts, precision)
    if kind is MutationKind.SAFE_GRAD_ABS:
        return abs_sens(forward, theta, idx, consts)
    raise ValueError(f"no gradient sensitivity for {kind}")


def calc_sensitivity(task, theta, idx, kind: MutationKind, underflow: float,
                     precision: str = "float32",
                     probes: torch.Tensor | None = None) -> torch.Tensor:
    """The post-processed (dim,) sensitivity of one flat theta over the
    batch rows ``idx`` (a long tensor on theta's device), by kind;
    ``task.sensitivity_forward(theta, idx, consts)`` gives the (B, K)
    grouped output. ``probes``: an (R, K) Rademacher matrix for SM-G-SUM's
    estimator (``tpu.sensitivity_probes``; the JAX package takes a key
    there), or None for the exact sweep. No host sync."""
    return postprocess(_raw(task, theta, idx, kind, precision, probes),
                       underflow)


def calc_sensitivities(task, thetas, idx, kind: MutationKind,
                       underflow: float, precision: str = "float32",
                       probes: torch.Tensor | None = None) -> torch.Tensor:
    """(P, dim) rows of ``calc_sensitivity``, one per parent of ``thetas``
    (P, dim), all with the same batch rows and probes: the NIC-ES
    per-(task, parent) sensitivity of the reference (safe_mutations.py:
    34-84) as one sweep per generation. The parents go through
    ``torch.func.vmap`` in groups of ``SENS_GROUP`` (the last one padded by
    repeating its last parent), so the sweep's host work is paid once per
    group. Every group has the same shapes, and a row's arithmetic does not
    depend on the other rows of its group, so a row has the same bits
    whatever P is and wherever it sits."""
    out = torch.empty_like(thetas, dtype=torch.float32)

    def raw(theta):
        return _raw(task, theta, idx, kind, precision, probes)

    for lo in range(0, thetas.shape[0], SENS_GROUP):
        rows = thetas[lo:lo + SENS_GROUP]
        n = rows.shape[0]
        if n < SENS_GROUP:
            rows = torch.cat([rows, rows[-1:].expand(SENS_GROUP - n, -1)])
        out[lo:lo + n] = postprocess(
            torch.func.vmap(raw)(rows.contiguous())[:n], underflow)
    return out
