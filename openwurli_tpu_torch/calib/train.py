"""Training of the per-note correction MLP (pipeline stage 6).

Architecture: Input(2) → Dense(H, ReLU) → Dense(H, ReLU) → Dense(11).
Masked, tier-weighted Huber loss (δ=5) on per-target-standardised residual
targets, full-batch Adam. Port of `openwurli_tpu/calib/train.py`: float64
torch with autograd and `torch.optim.Adam` on the batch's device. Only
w1…b3 train; target_means and target_stds stay frozen. The trained
weights save to the same npz keys, which `mlp.load_weights` reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import mlp

N_OUTPUTS = 11
N_FREQ = 5
N_DECAY = 5
DS_IDX = 10
HUBER_DELTA = 5.0
TRAINABLE = ("w1", "b1", "w2", "b2", "w3", "b3")


class TrainBatch(NamedTuple):
    inputs: torch.Tensor   # (N, 2) normalised (midi_norm, vel_norm)
    targets: torch.Tensor  # (N, 11) raw residual targets
    mask: torch.Tensor     # (N, 11) bool — valid entries
    weights: torch.Tensor  # (N,) isolation-tier weights


def init_weights(generator: torch.Generator, hidden=16, target_means=None,
                 target_stds=None, dtype=torch.float64,
                 device="cuda") -> mlp.MlpWeights:
    """Glorot-normal weights drawn from `generator` (a CPU generator),
    zero biases; the fields are tensors on `device`."""
    def glorot(shape):
        fan = shape[0] + shape[1]
        return torch.randn(shape, generator=generator, dtype=dtype) \
            * math.sqrt(2.0 / fan)

    def z(n):
        return torch.zeros(n, dtype=dtype)

    w = mlp.MlpWeights(
        w1=glorot((hidden, 2)), b1=z(hidden),
        w2=glorot((hidden, hidden)), b2=z(hidden),
        w3=glorot((N_OUTPUTS, hidden)), b3=z(N_OUTPUTS),
        target_means=z(N_OUTPUTS) if target_means is None
        else torch.as_tensor(target_means, dtype=dtype),
        target_stds=torch.ones(N_OUTPUTS, dtype=dtype) if target_stds is None
        else torch.as_tensor(target_stds, dtype=dtype))
    return mlp.MlpWeights(*[x.to(device) for x in w])


def standardise_targets(targets, mask):
    """Per-target mean/std over valid entries (train_mlp.py:104-113).

    Decay targets clipped to ±20, ds to [0.5, 2.0] before standardising.
    Returns (targets_clipped, means, stds)."""
    targets = targets.clone()
    targets[..., N_FREQ:N_FREQ + N_DECAY] = torch.clamp(
        targets[..., N_FREQ:N_FREQ + N_DECAY], -20.0, 20.0)
    targets[..., DS_IDX] = torch.clamp(targets[..., DS_IDX], 0.5, 2.0)
    m = mask.to(torch.float64)
    n_valid = torch.clamp(m.sum(dim=0), min=1.0)
    means = (targets * m).sum(dim=0) / n_valid
    var = ((targets - means) ** 2 * m).sum(dim=0) / n_valid
    stds = torch.clamp(torch.sqrt(var), min=1e-6)
    return targets, means, stds


def _forward_norm(weights: mlp.MlpWeights, inputs):
    """Forward pass in standardised-target space."""
    h1 = torch.relu(inputs @ weights.w1.T + weights.b1)
    h2 = torch.relu(h1 @ weights.w2.T + weights.b2)
    return h2 @ weights.w3.T + weights.b3


def masked_huber_loss(weights: mlp.MlpWeights, batch: TrainBatch):
    pred = _forward_norm(weights, batch.inputs)
    target_norm = (batch.targets - weights.target_means) / weights.target_stds
    diff = pred - target_norm
    abs_diff = torch.abs(diff)
    huber = torch.where(abs_diff < HUBER_DELTA, 0.5 * diff ** 2,
                        HUBER_DELTA * (abs_diff - 0.5 * HUBER_DELTA))
    m = batch.mask.to(pred.dtype)
    loss = huber * m * batch.weights[..., None]
    return loss.sum() / torch.clamp(m.sum(), min=1.0)


def make_train_step(learning_rate=1e-3):
    """Plain-Adam train step over the MlpWeights: init(weights) → the
    optimiser (the trainable fields become leaf tensors that it updates in
    place); step(weights, opt, batch) → (weights, opt, loss before the
    update)."""
    def init(weights):
        for k in TRAINABLE:
            getattr(weights, k).requires_grad_(True)
        return torch.optim.Adam([getattr(weights, k) for k in TRAINABLE],
                                lr=learning_rate)

    def step(weights, opt, batch):
        opt.zero_grad(set_to_none=True)
        loss = masked_huber_loss(weights, batch)
        loss.backward()
        opt.step()
        return weights, opt, loss.detach()

    return init, step


def train(batch: TrainBatch, hidden=16, epochs=2000, learning_rate=1e-3,
          seed=0, log_every=0):
    """Full-batch training loop on the batch's device. Returns trained
    MlpWeights (detached tensors)."""
    targets, means, stds = standardise_targets(batch.targets, batch.mask)
    batch = batch._replace(targets=targets)
    gen = torch.Generator().manual_seed(seed)
    weights = init_weights(gen, hidden, target_means=means,
                           target_stds=stds, device=batch.inputs.device)
    weights = mlp.MlpWeights(*[x.detach().clone() for x in weights])
    init, step = make_train_step(learning_rate)
    opt = init(weights)
    for epoch in range(epochs):
        weights, opt, loss = step(weights, opt, batch)
        if log_every and epoch % log_every == 0:
            print(f"epoch {epoch}: loss {float(loss):.5f}")
    return mlp.MlpWeights(*[x.detach() for x in weights])


def save_weights(weights: mlp.MlpWeights, path):
    np.savez(path, **{k: np.asarray(getattr(weights, k).detach().cpu())
                      for k in mlp.MlpWeights._fields})
