"""The DI path's preamp in the PyTorch port (`di.preamp_di`,
`di.render_di`) against the JAX package's (CPU, float64, kernel E5<dk>'s
plain version).

4 notes × 2 velocities × 0.05 s at 44.1 and 96 kHz: `preamp_di` on the
reference's voice audio, and `render_di` whole (the port's voices through
the port's preamp). Target: each voice within -120 dB RMS of the
reference's. The twin preamp's main − shadow difference carries XLA's
multiply-add contractions (ROADMAP queue 3), so a voice that misses it is
gated at the reference's own response to a 1-ulp perturbation of the
preamp state entering every step (two seeds, the larger) + 3 dB. A voice
the reference renders as exact silence must be exact silence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import di as jdi
from openwurli_tpu import voice as jvoice
from openwurli_tpu.circuits import dk_preamp as jdk
from openwurli_tpu.ops import allpass as jap
from openwurli_tpu_torch import di
from test_torch_di import TARGET_DB, _db

torch.set_num_threads(1)

GATE_DB = 3.0


def _twin_preamp_di(audio, sr, seed):
    """The reference's preamp_di with the DK state entering every step
    moved by one ulp (random directions from `seed`)."""
    pre_params = jdk.make_params(sr * 2.0)
    batch = audio.shape[1:]
    g = jnp.broadcast_to(jdk.ldr_conductance(1_000_000.0), batch)
    key = jax.random.PRNGKey(seed)

    def nudge(tree, k):
        leaves, tdef = jax.tree.flatten(tree)
        ks = jax.random.split(k, len(leaves))
        return jax.tree.unflatten(tdef, [
            jnp.nextafter(x, jnp.where(jax.random.bernoulli(kk, 0.5, x.shape),
                                       jnp.inf, -jnp.inf))
            for x, kk in zip(leaves, ks)])

    @jax.jit
    def chain(xs):
        def body(carry, tx):
            t, x = tx
            os_st, pre = carry
            pre = nudge(pre, jax.random.fold_in(key, t))
            os_st, (e, o) = jap.up_step(os_st, x)
            pre, y0 = jdk.step(pre_params, pre, g, e)
            pre, y1 = jdk.step(pre_params, pre, g, o)
            os_st, y = jap.down_step(os_st, y0, y1)
            return (os_st, pre), y

        carry = (jap.init_state(batch), jdk.init_state(pre_params, batch))
        return jax.lax.scan(body, carry, (jnp.arange(xs.shape[0]), xs))[1]

    return np.asarray(chain(jnp.asarray(audio)))


def _assert_di_gate(name, port, ref, twins):
    db = _db(port, ref)
    twin_db = np.max([_db(t, ref) for t in twins], axis=0)
    silent = np.all(ref == 0.0, axis=0)
    assert np.array_equal(port[:, silent], ref[:, silent]), name
    gate = np.maximum(TARGET_DB, twin_db + GATE_DB)
    print(f"{name}: port {db.round(1)} dB, twin {twin_db.round(1)} dB")
    assert (db[~silent] <= gate[~silent]).all(), (name, db, gate)


@pytest.mark.parametrize("sr", [44100.0, 96000.0])
def test_preamp_di_and_render_di_match_reference(sr):
    m = np.repeat([45.0, 57.0, 69.0, 81.0], 2)
    v = np.tile([0.3, 0.9], 4)
    audio = np.asarray(jvoice.render_note(jnp.asarray(m), jnp.asarray(v),
                                          0.05, sr, mlp_enabled=True))
    ref = np.asarray(jdi.preamp_di(audio, sr))
    twins = [_twin_preamp_di(audio, sr, s) for s in (1, 2)]
    out = di.preamp_di(torch.from_numpy(audio.copy()), sr, device="cpu")
    assert out.device.type == "cpu" and out.shape == audio.shape
    _assert_di_gate(f"preamp_di {sr:g}", out.numpy(), ref, twins)
    # a single (n,) stream keeps its shape
    one = di.preamp_di(torch.from_numpy(audio[:, 1].copy()), sr,
                        device="cpu")
    assert one.shape == (audio.shape[0],)
    # the whole path: the port's voices through the port's preamp
    whole = di.render_di(m, v, 0.05, sr, device="cpu")
    ref_whole = jdi.render_di(jnp.asarray(m), jnp.asarray(v), 0.05, sr)
    assert isinstance(whole, np.ndarray) and whole.shape == ref_whole.shape
    _assert_di_gate(f"render_di {sr:g}", whole, ref_whole, twins)
