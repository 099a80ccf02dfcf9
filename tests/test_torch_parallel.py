"""The multi-device path of the PyTorch port (`parallel/mesh.py`,
`parallel/dryrun.py`, `fast.render_grid_sharded`, `entry.py`) on the CPU,
over gloo process groups of 2-4 ranks (`dryrun.run_ranks`: spawned
processes that meet at a file store in a temporary directory), against
the JAX package's on `tests/conftest.py`'s 8 virtual CPU devices.

  * `shard_batch`: rank r holds the rows `NamedSharding(mesh, P("data"))`
    puts on the mesh's r-th device.
  * `sharded_grid_render` over 4 ranks: bit for bit the port's unsharded
    `voice.render`, and within 1e-12 (the gate `tests/test_torch_di.py`
    holds E4's plain version to) of the JAX `sharded_grid_render`.
  * `render_grid_sharded` over 4 ranks × 2 streams × 2 voices × 160
    samples, t_tile 64, per-stream volume and depth, a 64-sample warm-up:
    bit for bit each shard's standalone `render_grid` (the gate of
    `tests/test_fast_sharded.py:94-113`), with one shard's onsets ending
    well before another's, so that the global steady limit is larger than
    that shard's own.
  * The dry run's training step over 2 ranks: within 1e-12 of the same
    step in one process (the reference's gate), and of the JAX step (the
    reference's `train_step`, built here from `openwurli_tpu.voice`,
    `calib.goertzel` and `calib.train`) on the same initial weights within
    10× the gaps measured on this CPU: the loss within 1.4e-12 relative
    (measured 1.38e-13: XLA's and torch's log10 and sum orders), the
    weights within 2.2e-15 (measured 2.2e-16). The port's own initial
    weights (threefry through `prng`) within the 64 ulps
    `prng.normal_f64` is held to of the JAX package's
    `init_weights(PRNGKey(0))`.
  * `entry(device="cpu")`: its four inputs those of the JAX package's
    `__graft_entry__.entry()`, bit for bit apart from the dwell filter's
    1e-19 mode amplitudes (within 4e-6 relative there); (1024, 8) finite
    audio, equal to its own
    composition of the plain K1, the lane sum and the plain K2 (K1's
    output and state whole, K2 over the first 128 samples: the chain is
    causal, and its whole plain span costs ~20 s on one core).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from openwurli_tpu.parallel import mesh as jmesh
from openwurli_tpu_torch import mlp, voice
from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb
from openwurli_tpu_torch.parallel import dryrun
from openwurli_tpu_torch.parallel import mesh as meshlib

torch.set_num_threads(1)

# 10x the gaps measured on this CPU (loss 1.38e-13 of 1.64, weights 2.2e-16)
LOSS_GATE_REL = 1.4e-12
WEIGHTS_GATE = 2.2e-15


def test_shard_batch_order_matches_named_sharding():
    devices = jax.devices("cpu")[:8]
    jm = jmesh.make_mesh(devices)
    x = np.arange(48.0).reshape(16, 3)
    placed = jax.device_put(x, NamedSharding(jm, P(jmesh.DATA_AXIS)))
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    for r, d in enumerate(jm.devices):
        mesh = meshlib.Mesh(r, 8, torch.device("cpu"))
        got_np, (got_t,) = meshlib.shard_batch(mesh, (x, [torch.from_numpy(
            x)]))
        assert isinstance(got_np, np.ndarray) and torch.is_tensor(got_t)
        np.testing.assert_array_equal(got_np, by_device[d])
        np.testing.assert_array_equal(got_t.numpy(), by_device[d])
    with pytest.raises(ValueError, match="does not split"):
        meshlib.shard_batch(meshlib.Mesh(0, 3, torch.device("cpu")), x)


def test_sharded_grid_render_matches_unsharded_and_reference():
    g = np.linspace(40.0, 82.0, 8)
    v = np.linspace(0.3, 1.0, 8)
    sr, dur = 8000.0, 0.01
    out = dryrun.run_ranks(4, "cpu", meshlib.sharded_grid_render, g, v,
                           dur, sr)
    assert out.dtype == torch.float64 and out.shape == (80, 8)
    vparams, detuned = voice.note_on_params(g, v, sr, mlp_enabled=False)
    state = voice.init_state(vparams, detuned, v, sr,
                             voice.default_note_seed(g))
    _, whole = voice.render(vparams, state, 80, device="cpu")
    assert torch.equal(out, whole)
    ref = np.asarray(jmesh.sharded_grid_render(
        jmesh.make_mesh(jax.devices("cpu")[:8]), g, v, dur, sr))
    err = float(np.abs(out.numpy() - ref).max())
    print(f"sharded_grid_render vs the JAX package's: {err:.3g} "
          f"(peak {np.abs(ref).max():.3g})")
    assert err <= 1e-12


def test_render_grid_sharded_bit_identical_to_each_shard():
    rng = np.random.default_rng(3)
    midis = rng.uniform(40.0, 90.0, size=(8, 2))
    midis[:2] = [[96.0, 100.0], [99.0, 101.0]]  # short onsets in shard 0
    volume = np.linspace(0.3, 0.8, 8)
    depth = np.tile([0.0, 0.9], 4)
    seconds = 160 / 44100.0
    limits = [vb.steady_limits(vb.make_kernel_params(
        midis[2 * r:2 * r + 2].reshape(-1), np.full(4, 0.7), 44100.0)[0])
        for r in range(4)]
    assert max(x[0] for x in limits) > limits[0][0] + 300, limits
    out, oracle = dryrun.run_ranks(4, "cpu", dryrun.phase2, midis, 0.7,
                                   seconds, t_tile=64, volume=volume,
                                   depth=depth, warm_seconds=40 / 44100.0)
    assert out.shape == (160, 8) and out.dtype == torch.float32
    assert torch.equal(out.view(torch.int32), oracle.view(torch.int32))


def _jax_step(weights, g, v):
    """The reference dry run's train_step (openwurli_tpu/parallel/
    dryrun.py:66-92), on one device."""
    from openwurli_tpu import voice as jvoice
    from openwurli_tpu.calib import goertzel, train

    sr, n_samples = dryrun.SR, dryrun.N_SAMPLES

    def train_step(weights, g, v):
        vparams, detuned = jvoice.note_on_params(g, v, sr,
                                                 mlp_enabled=False)
        vstate = jvoice.init_state(vparams, detuned, v, sr,
                                   jvoice.default_note_seed(g))
        _, audio = jvoice.render(vparams, vstate, n_samples)
        f0, mags = goertzel.harmonic_ladder(audio.T, detuned, sr,
                                            n_harmonics=6, refine=False)
        rel_db = 20.0 * jnp.log10(
            jnp.maximum(mags[:, 1:6], 1e-12)
            / jnp.maximum(mags[:, :1], 1e-12))
        targets = jnp.concatenate(
            [rel_db * 0.1, jnp.ones_like(rel_db),
             jnp.ones((g.shape[0], 1))], axis=-1)
        inputs = jnp.stack([(g - 21.0) / 87.0, v], axis=-1)
        batch = train.TrainBatch(
            inputs=inputs, targets=targets,
            mask=jnp.ones_like(targets, dtype=bool),
            weights=jnp.ones(g.shape[0]))
        loss, grads = jax.value_and_grad(train.masked_huber_loss)(
            weights, batch)
        return jax.tree.map(lambda w_, g_: w_ - 1e-3 * g_, weights,
                            grads), loss

    return jax.jit(train_step)(weights, jnp.asarray(g), jnp.asarray(v))


def test_dryrun_training_step_matches_one_process_and_reference():
    from openwurli_tpu.calib import train as jtrain

    jw = jtrain.init_weights(jax.random.PRNGKey(0))
    w0 = mlp.MlpWeights(*[np.array(x, dtype=np.float64) for x in jw])
    # the port's own initial weights: the same draws, the normals within
    # prng.normal_f64's 64-ulp gate (XLA's own log1p; ROADMAP queue 3)
    own = dryrun.init_weights(0)
    for a, b in zip(own, w0):
        np.testing.assert_array_max_ulp(a, b, maxulp=64)

    r = dryrun.run_ranks(2, "cpu", dryrun.phase1, w0)
    assert r["line"].endswith("— OK")
    assert np.isfinite(r["loss"]) and r["dW3"] > 0.0
    assert abs(r["loss"] - r["loss_1"]) <= dryrun.STEP_GATE
    for a, b in zip(r["weights"], r["weights_1"]):
        assert np.abs(a - b).max() <= dryrun.STEP_GATE

    g, v = dryrun.note_grid(2)
    new_w, loss = _jax_step(jw, g, v)
    d_loss = abs(r["loss"] - float(loss))
    d_w = max(float(np.abs(a - np.asarray(b)).max())
              for a, b in zip(r["weights"], new_w))
    print(f"dry-run step vs the JAX step: |dloss| {d_loss:.3g} (loss "
          f"{float(loss):.6f}), |dW|max {d_w:.3g}")
    assert d_loss <= LOSS_GATE_REL * abs(float(loss))
    assert d_w <= WEIGHTS_GATE


def test_entry_cpu_equals_its_plain_composition():
    from openwurli_tpu_torch import entry

    fn, args = entry.entry(device="cpu")
    params, vstate, ctrl, cstate = args
    # the JAX package's entry() inputs, bit for bit apart from the mode
    # amplitudes the hammer's dwell filter leaves below 1e-18 (modes 5-6
    # here, ~1e-19), where the two float64 exps differ by ~1e-6 relative
    # (tests/test_torch_packers.py): there within 4e-6 (measured 1.9e-6)
    import __graft_entry__

    _, ref_args = __graft_entry__.entry()
    for got, want in zip(args, ref_args):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        differ = got.view(np.int32) != want.view(np.int32)
        if got.shape == params.shape:
            tail = np.zeros_like(differ)
            tail[vb.ROW_AMP] = np.abs(want[vb.ROW_AMP]) < 1e-18
            gap = np.abs(got[tail].astype(np.float64) - want[tail])
            assert (gap <= 4e-6 * np.abs(want[tail])).all()
            differ &= ~tail
        assert not differ.any(), np.argwhere(differ)[:8]
    assert params.shape[-1] == 512 and ctrl.shape == (mc.CTRL_ROWS, 8)
    before = (vb.PLAIN_CALLS, mc.PLAIN_CALLS)
    out, vstate2, cstate2 = fn(*args)
    assert (vb.PLAIN_CALLS, mc.PLAIN_CALLS) == (before[0] + 1,
                                                before[1] + 1)
    assert out.shape == (1024, 8) and out.dtype == torch.float32
    assert torch.isfinite(out).all() and (out.abs().max(0).values > 0).all()
    assert cstate2.shape == cstate.shape and vstate2.shape == vstate.shape

    voices, v_st = vb.render_voice_bank_plain(params, 1024, state=vstate,
                                              return_state=True)
    assert torch.equal(v_st.view(torch.int32), vstate2.view(torch.int32))
    audio = voices.reshape(1024, 8, 64).sum(-1).contiguous()
    head, _ = mc.render_chain_plain(mc.pack_consts(entry.SR), ctrl, cstate,
                                    audio[:128].contiguous())
    assert torch.equal(head.view(torch.int32),
                       out[:128].contiguous().view(torch.int32))
