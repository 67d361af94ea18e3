"""NIC-NES engine (port of ``NESEngine`` in ``nes_img_captioning_tpu/algorithms/nes.py``).

One generation, in the decode-ordered parameter layout (ops/decode_layout.py):

1. each antithetic pair gets ``delta = dt(scale_dec * N(0, 1))`` drawn from
   its seed and rounded once to the storage dtype (``tpu.delta_dtype``);
2. the pair kernel (K2, ``tpu.kernel_perturb``) decodes both rollouts of
   every pair of a chunk in one launch, or the per-member path decodes the
   chunk's 2 x chunk members ``base ± delta`` with K1 in one launch;
3. CIDEr-D scores every decoded row on the device;
4. centered ranks give the pair weights (pad lanes weight 0);
5. the gradient sum_i w_i * delta_i is rebuilt from deltas drawn again from
   the seeds and mapped back with ``from_dec``;
6. the optimizer steps, and ``[fitness | ratio | mean|theta|]`` is packed.

The two eval paths feed the fitness scorer the same tensors laid out the
same way, so with equal tokens their packed vectors are bitwise equal.
Reference math: src/algorithm/nic_nes/nic_nes_master.py:123-133,170-182.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine_base import PopulationEngine
from ..ops.mutation import MutationKind, normal_from_seed, shape_noise
from ..ops.ranks import compute_centered_ranks

__all__ = ["NESEngine"]


class NESEngine(PopulationEngine):
    """Device-side math for NES generations on one card."""

    def __init__(self, task, optimizer, mutation: MutationKind,
                 pop_chunk: int = 0, kernel_perturb: object = "auto",
                 delta_dtype: str = "f32"):
        super().__init__(task, pop_chunk=pop_chunk)
        self.optimizer = optimizer
        if mutation in (MutationKind.SAFE_GRAD_SUM, MutationKind.SAFE_GRAD_ABS):
            raise NotImplementedError(
                "SM-G-* mutations need the sensitivity sweep, not ported yet")
        self.mutation = mutation
        self._layout = (getattr(task, "decode_layout", None)
                        if task.fitness_on_device else None)
        if self._layout is None:
            raise NotImplementedError(
                "only the decode-layout generation (fused decode + device "
                "CIDEr-D) is ported yet")
        # "auto" and True both take the pair kernel where the task has it
        self._kernel_perturb = (kernel_perturb is not False
                                and task.supports_pair_perturb)
        if delta_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"delta_dtype={delta_dtype!r}: expected 'f32' or 'bf16'")
        self._delta_dtype = (torch.bfloat16 if delta_dtype == "bf16"
                             else torch.float32)

    # ---- math ----------------------------------------------------------------------

    def _scale_vec(self, theta, sens, sigma):
        """Member-independent noise scale: delta == scale_vec * N(0, 1) for
        every mutation kind this engine takes."""
        return shape_noise(
            torch.full_like(theta, float(sigma)), theta,
            sensitivity=sens if self.mutation.is_safe else None,
            proportional=self.mutation.is_proportional)

    def delta_of(self, scale_dec: torch.Tensor, seed: int) -> torch.Tensor:
        """The pair's decode-ordered delta, rounded once to the storage
        dtype: eval and gradient both consume this value."""
        noise = normal_from_seed(seed, scale_dec.shape[0], scale_dec.device)
        return (scale_dec * noise).to(self._delta_dtype)

    def _deltas(self, scale_dec, seeds_c) -> torch.Tensor:
        return torch.stack([self.delta_of(scale_dec, int(s)) for s in seeds_c])

    def _apply_grad(self, theta, opt_state, grad, fitness_count, stepsize,
                    l2coeff):
        """reference math: nic_nes_master.py:123-133,170-182."""
        globalg = -(grad / fitness_count) + l2coeff * theta
        return self.optimizer.step(opt_state, theta, globalg, stepsize)

    @staticmethod
    def _pair_weights(fitnesses, lanes_shape):
        """Per-pair weights from the (F, 2) fitnesses, zero-padded to the
        (n_chunks, chunk) lane layout (pad lanes repeat a real seed)."""
        ranked = compute_centered_ranks(fitnesses)
        w = ranked[:, 0] - ranked[:, 1]
        n_lanes = lanes_shape[0] * lanes_shape[1]
        w = torch.nn.functional.pad(w, (0, n_lanes - w.shape[0]))
        return w.reshape(lanes_shape)

    # ---- host entry points ----------------------------------------------------------

    def generation(self, theta, opt_state, sens, sigma, seeds: np.ndarray,
                   idx: np.ndarray, stepsize: float, l2coeff: float):
        """One generation. seeds (F,) uint32, idx (F, B) int rows of the
        training set. Returns (theta, opt_state, packed) with packed =
        [fitnesses (2F) | ratio | mean|theta|] on theta's device."""
        task, lay = self.task, self._layout
        dev = theta.device
        F = seeds.shape[0]
        n_chunks, chunk = self._plan(F)
        seeds_l = self._lay_out(np.asarray(seeds, np.uint32), n_chunks, chunk)
        idx_l = torch.as_tensor(
            self._lay_out(np.asarray(idx, np.int64), n_chunks, chunk),
            device=dev)
        consts = task.device_consts()

        base_vec = lay.to_dec(theta)
        scale_dec = lay.to_dec(self._scale_vec(theta, sens, sigma),
                               pad_scale=0.0)
        if self._kernel_perturb:
            base_params = task.pair_base_params(base_vec)
        fits = []
        for c in range(n_chunks):
            deltas = self._deltas(scale_dec, seeds_l[c])
            if self._kernel_perturb:
                fits.append(task.rollout_pair_dec(base_params, deltas,
                                                  idx_l[c], consts=consts))
            else:
                # pair-major members: row 2i is +delta_i, row 2i+1 -delta_i
                members = torch.stack([base_vec + deltas, base_vec - deltas],
                                      1).reshape(2 * chunk, -1)
                fits.append(task.rollout_dec(
                    members, idx_l[c].repeat_interleave(2, 0),
                    consts=consts).reshape(chunk, 2))
        fitnesses = torch.cat(fits).reshape(-1, 2)[:F]

        weights = self._pair_weights(fitnesses, seeds_l.shape)
        grad = torch.stack([
            weights[c] @ self._deltas(scale_dec, seeds_l[c]).to(torch.float32)
            for c in range(n_chunks)]).sum(0)
        opt_state, theta, ratio = self._apply_grad(
            theta, opt_state, lay.from_dec(grad), fitnesses.numel(), stepsize,
            l2coeff)
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

    @staticmethod
    def unpack(packed, F: int):
        """(fitnesses (F, 2), ratio, mean|theta|) as numpy; accepts a (2F+2,)
        vector or a (K, 2F+2) block."""
        arr = packed.detach().cpu().numpy() if torch.is_tensor(packed) \
            else np.asarray(packed)
        fits = arr[..., :-2].reshape(*arr.shape[:-1], F, 2)
        return fits, arr[..., -2], arr[..., -1]
