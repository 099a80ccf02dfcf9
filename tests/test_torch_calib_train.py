"""The correction MLP's training in the PyTorch port (`calib.train`,
float64 autograd, `torch.optim.Adam`) against the JAX package's (optax
Adam, jitted), on the same seeded batch and the same initial weights: the
JAX draw from `jax.random` is carried across (`convert.
mlp_weights_from_numpy`), as the port draws from a torch Generator.

Tolerances: `standardise_targets` and `masked_huber_loss` within 1e-13
relative (sum orders differ); 50 Adam steps: each step's loss within
1e-10 relative, the final weights within 1e-9 relative of each array's
magnitude (torch's Adam and optax's round the same update in a different
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openwurli_tpu.calib import train as jtrain
from openwurli_tpu_torch import convert, mlp
from openwurli_tpu_torch.calib import train

torch.set_num_threads(1)


def _batch(seed=0, n=40):
    rng = np.random.default_rng(seed)
    inputs = rng.uniform(0, 1, (n, 2))
    targets = rng.normal(size=(n, 11)) * np.array([30.0] * 5 + [3.0] * 5
                                                   + [0.4]) + 1.0
    targets[0, 5] = 80.0                  # clipped to ±20
    targets[1, 10] = 5.0                  # clipped to [0.5, 2]
    mask = rng.random((n, 11)) < 0.8
    mask[:, 7] = False                    # a target with no valid entry
    weights = rng.choice([1.0, 0.6, 0.3], n)
    return jtrain.TrainBatch(jnp.asarray(inputs), jnp.asarray(targets),
                             jnp.asarray(mask), jnp.asarray(weights))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_standardise_and_loss_match_reference():
    jb = _batch()
    b = convert.train_batch_from_numpy(jb)
    assert b.mask.dtype == torch.bool and b.inputs.dtype == torch.float64
    tc, means, stds = train.standardise_targets(b.targets, b.mask)
    jtc, jmeans, jstds = jtrain.standardise_targets(jb.targets, jb.mask)
    for a, r in ((tc, jtc), (means, jmeans), (stds, jstds)):
        assert _rel(a.numpy(), r) <= 1e-13
    assert float(stds[7]) == 1e-6
    assert torch.equal(b.targets, convert.train_batch_from_numpy(
        jb).targets)                      # the input is not modified
    jw = jtrain.init_weights(jax.random.PRNGKey(3), 16, jmeans, jstds)
    w = convert.mlp_weights_from_numpy(jw)
    loss = train.masked_huber_loss(w, b._replace(targets=tc))
    ref = jtrain.masked_huber_loss(jw, jb._replace(targets=jtc))
    assert abs(float(loss) - float(ref)) <= 1e-13 * abs(float(ref))


def test_adam_steps_match_reference():
    jb = _batch(1)
    jtc, jmeans, jstds = jtrain.standardise_targets(jb.targets, jb.mask)
    jb = jb._replace(targets=jtc)
    jw = jtrain.init_weights(jax.random.PRNGKey(0), 16, jmeans, jstds)
    jinit, jstep = jtrain.make_train_step(1e-2)
    jopt = jinit(jw)
    w = convert.mlp_weights_from_numpy(jw)
    b = convert.train_batch_from_numpy(jb)
    init, step = train.make_train_step(1e-2)
    opt = init(w)
    for k in range(50):
        jw, jopt, jloss = jstep(jw, jopt, jb)
        w, opt, loss = step(w, opt, b)
        assert abs(float(loss) - float(jloss)) <= 1e-10 * abs(float(jloss)), k
    for name in mlp.MlpWeights._fields:
        a = getattr(w, name).detach().numpy()
        r = np.asarray(getattr(jw, name))
        assert _rel(a, r) <= 1e-9, (name, _rel(a, r))
    # the frozen fields did not move
    assert _rel(w.target_means.detach().numpy(), jmeans) == 0.0
    assert _rel(w.target_stds.detach().numpy(), jstds) == 0.0


def test_train_reduces_loss():
    """tests/test_calib_pipeline.py:126-145, in the port."""
    rng = np.random.default_rng(0)
    inputs = torch.from_numpy(rng.uniform(0, 1, (64, 2)))
    w_true = rng.normal(size=(2, 11))
    targets = torch.from_numpy(inputs.numpy() @ w_true * 3.0)
    batch = train.TrainBatch(inputs=inputs, targets=targets,
                             mask=torch.ones((64, 11), dtype=torch.bool),
                             weights=torch.ones(64, dtype=torch.float64))
    targets_c, means, stds = train.standardise_targets(batch.targets,
                                                       batch.mask)
    batch = batch._replace(targets=targets_c)
    weights = train.init_weights(torch.Generator().manual_seed(0), 16,
                                 means, stds, device="cpu")
    init, step = train.make_train_step(1e-2)
    opt = init(weights)
    loss0 = float(train.masked_huber_loss(weights, batch).detach())
    for _ in range(200):
        weights, opt, loss = step(weights, opt, batch)
    assert float(loss) < loss0 * 0.3, (loss0, float(loss))


def test_trained_weights_load_in_the_engine(tmp_path):
    jb = _batch(2)
    b = convert.train_batch_from_numpy(jb)
    w = train.train(b, hidden=16, epochs=20)
    assert all(not x.requires_grad for x in w)
    path = tmp_path / "w.npz"
    train.save_weights(w, path)
    loaded = mlp.load_weights(str(path))
    for name in mlp.MlpWeights._fields:
        np.testing.assert_array_equal(getattr(loaded, name),
                                      getattr(w, name).numpy())
    with np.load(path) as z:
        assert sorted(z.files) == sorted(mlp.MlpWeights._fields)
    corr = mlp.infer(np.array([70.0, 90.0]), np.array([0.5, 0.9]),
                     weights=loaded)
    assert np.isfinite(corr.freq_offsets_cents).all()
