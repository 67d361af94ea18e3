"""NIC-NES on the FC captioner in plain torch: the first generations of a
run, worked out again from the run's inputs and seed.

What it follows, from the experiment and the seed alone:

* the run's host draws: one ``numpy`` generator seeded with the seed gives
  the initial theta's generator seed, then per generation the pairs' uint32
  seeds; the epoch sampler, seeded by that generator's next draw at the
  first batch, gives each pair its own batch (``choice`` without
  replacement);
* the initial theta: torch's generator on the run's device, every weight
  xavier-normal in the model's parameter order, every bias 0;
* the parameter layout the noise is drawn in: the weights transposed to
  (in, out), the vocabulary axis padded to a multiple of 128 (the padded
  logit bias at -1e9, every other pad 0), so each pair's delta is
  sigma * N(0, 1) over that vector from a fresh torch generator seeded with
  the pair's seed, 0 on the pads;
* the greedy decode of each member base +- delta: an LSTM with a maxout
  cell (gates i, f, o; candidate max of two blocks), the image embedding as
  its first input and token 0 as the first word, T steps, a row's tokens 0
  after its first 0; weights, features, the first input and the state fed
  to the logits rounded to the configuration's precision, every product
  summed in f32, biases f32;
* the fitness: mean CIDEr-D x 100 of a member's rows against the train
  references (document frequencies over the train images); the pair
  weights: centered ranks of the (pairs, 2) fitnesses, ties in position
  order, + minus -; the gradient sum_i w_i delta_i in pair order, divided by
  the 2 x pairs fitnesses, negated, plus l2 x theta; then Adam;
* the validation before each update: the greedy captions of the val images
  scored with plain CIDEr (document frequencies over the val references),
  at the word level.

Each generation starts from the reference's own state after the previous
one, or from a state it is handed (a run's theta and Adam moments after
its previous step); its draws (seeds, batches) are always its own.

``quant`` names the rounding of the products' operands: "bf16" (the
configuration's), or "fp8", e4m3 with a scale per tensor (per member), the
control's. ``fault`` plants one of the faults the comparison has to catch,
for the readings that bound its limits: "half" (a member's fitness the mean
over the first half of its batch), "token" (every rollout row's first token
altered where it is decoded).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cider import Cider

__all__ = ["Model", "NESReference", "quantizer"]

NEG = -1e9
LANE = 128
# pairs decoded together, for memory only: the result does not depend on it
CHUNK_PAIRS = 48


def quantizer(kind: str):
    """x -> x rounded to ``kind`` and back to f32. fp8: e4m3 with the scale
    amax / 448 over the last two axes (one tensor of one member)."""
    if kind == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        def q(x):
            x = x.to(torch.float32)
            red = tuple(range(max(x.dim() - 2, 0), x.dim()))
            s = x.abs().amax(dim=red, keepdim=True).clamp(min=1e-30) / 448.0
            return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return q
    raise ValueError(f"unknown precision {kind!r}")


class Model:
    """The FC captioner's parameters: torch order (the leaves of the
    reference model, weights (out, in)) and the decode order the noise is
    drawn in."""

    def __init__(self, E: int, R: int, F: int, V: int):
        self.E, self.R, self.F = E, R, F
        self.V1 = V + 1
        self.Vpad = -(-self.V1 // LANE) * LANE
        V1 = self.V1
        self.leaves = [("img_embed.weight", (E, F)), ("img_embed.bias", (E,)),
                       ("embed.weight", (V1, E)), ("logit.weight", (V1, R)),
                       ("logit.bias", (V1,)),
                       ("core.i2h.weight", (5 * R, E)),
                       ("core.i2h.bias", (5 * R,)),
                       ("core.h2h.weight", (5 * R, R)),
                       ("core.h2h.bias", (5 * R,))]
        self.offsets, off = {}, 0
        for name, shape in self.leaves:
            self.offsets[name] = (off, shape)
            off += int(np.prod(shape))
        self.dim = off
        Vp = self.Vpad
        # decode-order tensors: (name, leaf, shape, transposed, vocab axis)
        self.dec = [("img_w", "img_embed.weight", (F, E), True, None),
                    ("img_b", "img_embed.bias", (E,), False, None),
                    ("i2h_w", "core.i2h.weight", (E, 5 * R), True, None),
                    ("i2h_b", "core.i2h.bias", (5 * R,), False, None),
                    ("h2h_w", "core.h2h.weight", (R, 5 * R), True, None),
                    ("h2h_b", "core.h2h.bias", (5 * R,), False, None),
                    ("logit_w", "logit.weight", (R, Vp), True, 1),
                    ("logit_b", "logit.bias", (Vp,), False, 0),
                    ("embed", "embed.weight", (Vp, E), False, 0)]
        self.dec_off, off = {}, 0
        for name, _, shape, _, _ in self.dec:
            self.dec_off[name] = (off, shape)
            off += int(np.prod(shape))
        self.dim_dec = off

    def leaf(self, theta: torch.Tensor, name: str) -> torch.Tensor:
        off, shape = self.offsets[name]
        return theta[off:off + int(np.prod(shape))].reshape(shape)

    def init_theta(self, seed: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        parts = []
        for name, shape in self.leaves:
            if name.endswith("bias"):
                parts.append(torch.zeros(shape, device=device))
            else:
                std = math.sqrt(2.0 / (shape[0] + shape[1]))
                parts.append(std * torch.randn(shape, generator=gen,
                                               device=device))
        return torch.cat([p.reshape(-1) for p in parts])

    def to_dec(self, theta: torch.Tensor, pad: float) -> torch.Tensor:
        """Torch order -> decode order, the logit bias's pads at ``pad``."""
        parts = []
        for name, leaf, shape, tr, vax in self.dec:
            t = self.leaf(theta, leaf)
            t = t.t() if tr else t
            if vax is not None:
                widths = [0, 0] * t.dim()
                widths[2 * (t.dim() - 1 - vax) + 1] = self.Vpad - self.V1
                t = torch.nn.functional.pad(
                    t, widths, value=pad if name == "logit_b" else 0.0)
            parts.append(t.reshape(-1))
        return torch.cat(parts)

    def from_dec(self, vec: torch.Tensor) -> torch.Tensor:
        """Decode order -> torch order, the pads dropped."""
        out = {}
        for name, leaf, shape, tr, vax in self.dec:
            off, _ = self.dec_off[name]
            t = vec[off:off + int(np.prod(shape))].reshape(shape)
            if vax is not None:
                t = t.narrow(vax, 0, self.V1)
            out[leaf] = t.t() if tr else t
        return torch.cat([out[n].reshape(-1) for n, _ in self.leaves])

    def tensors(self, vecs: torch.Tensor) -> dict:
        """Decode-order members (M, dim_dec) -> {name: (M, *shape)}."""
        M = vecs.shape[0]
        return {name: vecs[:, off:off + int(np.prod(shape))].reshape(
            M, *shape) for name, (off, shape) in self.dec_off.items()}

    def greedy(self, w: dict, feats: torch.Tensor, T: int, quant: str):
        """Greedy tokens (M, B, T) of M members w {name: (M, ...)} (weights
        already rounded, f32) on feats (M, B, F)."""
        q = quantizer(quant)
        R = self.R
        M, B = feats.shape[:2]
        dev = feats.device

        def lstm(x, h, c):
            a = (torch.bmm(x, w["i2h_w"]) + w["i2h_b"][:, None]
                 + torch.bmm(h, w["h2h_w"]) + w["h2h_b"][:, None])
            g = torch.sigmoid(a[..., :3 * R])
            cand = torch.maximum(a[..., 3 * R:4 * R], a[..., 4 * R:])
            c = g[..., R:2 * R] * c + g[..., :R] * cand
            return g[..., 2 * R:3 * R] * torch.tanh(c), c

        x0 = torch.bmm(q(feats), w["img_w"]) + w["img_b"][:, None]
        zero = torch.zeros((M, B, R), device=dev)
        h, c = lstm(q(x0), zero, zero)
        tok = torch.zeros((M, B), dtype=torch.long, device=dev)
        live = torch.ones((M, B), dtype=torch.bool, device=dev)
        rows = torch.arange(M, device=dev)[:, None]
        out = []
        for _ in range(T):
            h, c = lstm(w["embed"][rows, tok], h, c)
            logits = torch.bmm(q(h), w["logit_w"]) + w["logit_b"][:, None]
            new = logits.argmax(-1)
            live = live & (new > 0)
            tok = new * live
            out.append(tok)
        return torch.stack(out, -1)

    def members(self, base: torch.Tensor, deltas: torch.Tensor, quant: str
                ) -> dict:
        """The pairs' members base + delta_i (row 2i) and base - delta_i
        (row 2i + 1), each weight rounded once to ``quant``."""
        q = quantizer(quant)
        vecs = torch.stack([base + deltas, base - deltas], 1).reshape(
            2 * deltas.shape[0], -1)
        w = self.tensors(vecs)
        return {k: (v if k.endswith("_b") else q(v)) for k, v in w.items()}


def centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """Ranks of the flattened x in [-0.5, 0.5]; ties in position order."""
    flat = x.reshape(-1).cpu().numpy()
    ranks = np.empty(flat.shape[0], np.float32)
    ranks[np.argsort(flat, kind="stable")] = np.arange(flat.shape[0])
    y = ranks / np.float32(flat.shape[0] - 1) - np.float32(0.5)
    return torch.as_tensor(y.reshape(x.shape), device=x.device)


class NESReference:
    """The first generations of one run. ``arrays``: the data the run was
    handed; ``split``: its image rows per split; ``exp``: the experiment
    (its ``tpu.seed`` the run's seed); ``quant``: the products' rounding."""

    def __init__(self, exp: dict, arrays: dict, split: dict, device,
                 quant: str = "bf16", fault: str | None = None):
        if fault not in (None, "half", "token"):
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        mo = exp["policy_options"]["model_options"]
        cfg = exp["config"]
        V = len(arrays["info"]["ix_to_word"])
        self.m = Model(int(mo["input_encoding_size"]), int(mo["rnn_size"]),
                       int(mo["fc_feat_size"]), V)
        self.dev = device
        self.quant = quant
        self.pairs = int(exp["nb_offspring"])
        self.bs = int(cfg["batch_size"])
        self.sigma = float(cfg["noise_stdev"])
        self.l2 = float(cfg.get("l2coeff") or 0.0)
        self.stepsize = float(exp["optimizer_options"]["args"]["stepsize"])
        self.n_val = int(cfg.get("num_val_items") or 0)
        labels = torch.as_tensor(arrays["labels"])
        T = labels.shape[1]
        self.T = T
        caps = int(arrays["label_end_ix"][0] - arrays["label_start_ix"][0]
                   + 1)
        self.rng = np.random.default_rng(int(exp["tpu"]["seed"]))
        self.sampler = None
        feats = torch.as_tensor(arrays["feats"])
        tr, va = split["train"], split["val"]
        if self.n_val:
            va = va[:self.n_val]
        self.train_fc = feats[tr].to(device)
        self.val_fc = feats[va].to(device)
        per_img = labels.reshape(-1, caps, T)
        self.train_cider = Cider(per_img[tr].to(device), "cider-d")
        # validation scores word ids: equal word strings share one id
        words, table = {}, np.zeros(V + 1, np.int64)
        for t in range(1, V + 1):
            table[t] = words.setdefault(arrays["info"]["ix_to_word"][str(t)],
                                        len(words) + 1)
        self.word = torch.as_tensor(table, device=device)
        self.val_cider = Cider(self.word[per_img[va].to(device).long()],
                               "cider")
        self.theta = self.m.init_theta(
            int(self.rng.integers(0, 2**31 - 1)), device)
        self.m_adam = torch.zeros_like(self.theta)
        self.v_adam = torch.zeros_like(self.theta)
        self.t = 0

    def _batches(self) -> np.ndarray:
        n = self.train_fc.shape[0]
        if self.sampler is None:
            self.sampler = np.random.default_rng(
                int(self.rng.integers(0, 2**31 - 1)))
            self.sampler.permutation(n)  # the epoch's order, unused here
        return np.stack([self.sampler.choice(n, size=self.bs, replace=False)
                         for _ in range(self.pairs)])

    def _delta(self, seed: int, scale: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        return scale * torch.randn((self.m.dim_dec,), generator=gen,
                                   device=self.dev)

    def validate(self, theta: torch.Tensor) -> tuple[float, torch.Tensor]:
        """(mean plain CIDEr of theta's val captions, the tokens)."""
        q = quantizer(self.quant)
        w = self.m.tensors(self.m.to_dec(theta, NEG)[None])
        w = {k: (v if k.endswith("_b") else q(v)) for k, v in w.items()}
        seq = self.m.greedy(w, self.val_fc[None], self.T, self.quant)[0]
        img = torch.arange(seq.shape[0], device=self.dev)
        return float(self.val_cider.score(self.word[seq], img).mean()), seq

    def generation(self, state=None) -> dict:
        """One generation. ``state``: (theta, m, v) to start from, a run's
        own after its previous step (by default the reference's own).
        Returns the pairs' (F, 2) f32 fitnesses, the validation score of
        the pre-update theta, the gradient as Adam gets it (torch order),
        the state after the update (kept as the reference's), the rollouts'
        executed steps and the validation's tokens."""
        if state is not None:
            self.theta, self.m_adam, self.v_adam = (
                x.to(self.dev, torch.float32) for x in state)
        F = self.pairs
        seeds = self.rng.integers(0, 2**32, size=F, dtype=np.uint32)
        idx = torch.as_tensor(self._batches(), device=self.dev)
        val, val_seq = self.validate(self.theta)
        base = self.m.to_dec(self.theta, NEG)
        scale = self.m.to_dec(torch.full_like(self.theta, self.sigma), 0.0)
        fits, steps = [], []
        for lo in range(0, F, CHUNK_PAIRS):
            s = seeds[lo:lo + CHUNK_PAIRS]
            deltas = torch.stack([self._delta(x, scale) for x in s])
            w = self.m.members(base, deltas, self.quant)
            i = idx[lo:lo + len(s)].repeat_interleave(2, 0)
            seq = self.m.greedy(w, self.train_fc[i], self.T, self.quant)
            del w, deltas
            if self.fault == "token":
                seq[..., 0] = seq[..., 0] % (self.m.V1 - 1) + 1
            zero = seq == 0
            first0 = torch.where(zero.any(-1), zero.int().argmax(-1),
                                 self.T - 1)
            steps.append((first0.max(-1).values + 1).clamp(max=self.T))
            sc = self.train_cider.score(seq.reshape(-1, self.T),
                                        i.reshape(-1))
            sc = sc.reshape(seq.shape[:2])
            if self.fault == "half":
                sc = sc[:, :self.bs // 2]
            fits.append((sc.mean(-1) * 100.0).to(torch.float32)
                        .reshape(-1, 2))
        fit = torch.cat(fits)
        r = centered_ranks(fit)
        wts = r[:, 0] - r[:, 1]
        grad = torch.zeros_like(base)
        for k in range(F):
            grad = grad + wts[k] * self._delta(int(seeds[k]), scale)
        g = -(self.m.from_dec(grad) / (2 * F)) + self.l2 * self.theta
        self._adam(g)
        return {"fitness": fit.cpu(), "val": val, "grad": g.cpu(),
                "state": tuple(x.cpu() for x in (self.theta, self.m_adam,
                                                 self.v_adam)),
                "steps": torch.cat(steps).cpu(), "val_seq": val_seq.cpu()}

    def _adam(self, g: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8):
        self.t += 1

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=self.dev)

        tf = f32(float(self.t))
        a = (f32(self.stepsize) * torch.sqrt(1 - torch.pow(f32(b2), tf))
             / (1 - torch.pow(f32(b1), tf)))
        self.m_adam = b1 * self.m_adam + (1 - b1) * g
        self.v_adam = b2 * self.v_adam + (1 - b2) * (g * g)
        self.theta = self.theta + (-a * self.m_adam
                                   / (torch.sqrt(self.v_adam) + eps))
