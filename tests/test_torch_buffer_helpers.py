"""The buffer helpers of the PyTorch port (`reed.render`,
`ops.allpass.upsample_2x` / `downsample_2x`, `ops.biquad.process`,
`circuits.gp.diode_current_deriv`) against the JAX package's on seeded
inputs (CPU, float64; target: within 1e-12 of each output's magnitude),
and the reference tests' own cases for them run on the port
(`tests/test_reed_voice.py`, `tests/test_ops_speaker.py`,
`tests/test_gp.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import reed as jreed
from openwurli_tpu.circuits import gp as jgp
from openwurli_tpu.circuits import mna as jmna
from openwurli_tpu.ops import allpass as jap
from openwurli_tpu.ops import biquad as jbq
from openwurli_tpu_torch import reed
from openwurli_tpu_torch.circuits import gp, mna
from openwurli_tpu_torch.ops import allpass, biquad
from test_torch_engine_steps import np_tree, rel_errors, t_tree

torch.set_num_threads(1)

SR = 44100.0
TARGET = 1e-12
RATIOS = np.array([1.0, 6.267, 17.547, 34.386, 56.842, 85.1, 119.3])


def assert_close(name, port, ref):
    err = rel_errors(port, ref)
    worst = max(err.items(), key=lambda kv: kv[1])
    print(f"{name}: worst {worst[0]} {worst[1]:.3g}")
    assert worst[1] <= TARGET, err


def test_reed_render_matches_reference():
    """Three seeded voices (onset ramps, every mode, decays) over 1100
    samples: jitter draws every 16th sample and the renorm at 1024."""
    rng = np.random.default_rng(31)
    f0 = np.array([110.0, 440.0, 1318.5])
    amps = rng.uniform(0.0, 1.0, (3, 7))
    decays = rng.uniform(0.0, 40.0, (3, 7))
    onset = np.array([0.0, 0.004, 0.012])
    vel = np.array([1.0, 0.5, 0.1])
    seeds = np.array([7, 42, 4096], np.uint32)
    jp = jreed.make_params(jnp.asarray(f0), jnp.asarray(RATIOS),
                           jnp.asarray(amps), jnp.asarray(decays),
                           jnp.asarray(onset), jnp.asarray(vel), SR)
    js = jreed.init_state(jp, jnp.asarray(seeds))
    p = reed.make_params(f0, RATIOS, amps, decays, onset, vel, SR)
    s = reed.init_state(p, seeds)
    n = 1100
    port = reed.render(t_tree(p), t_tree(s), n)
    ref = np_tree(jreed.render(jp, js, n))
    assert port[1].shape == (n, 3)
    assert_close("reed.render", np_tree(jax.tree.map(
        lambda a: a.numpy(), port)), ref)


def test_oversampler_buffers_match_reference():
    rng = np.random.default_rng(32)
    x = rng.standard_normal((300, 3)) * 0.3
    js, jup = jap.upsample_2x(jap.init_state((3,)), jnp.asarray(x))
    js, jdown = jap.downsample_2x(js, jup * 0.5)
    ps, up = allpass.upsample_2x(allpass.init_state((3,)),
                                 torch.from_numpy(x))
    ps, down = allpass.downsample_2x(ps, up * 0.5)
    assert up.shape == (600, 3) and down.shape == (300, 3)
    assert_close("allpass buffers", np_tree(jax.tree.map(
        lambda a: a.numpy(), (ps, up, down))), np_tree((js, jup, jdown)))


def test_biquad_process_matches_reference():
    rng = np.random.default_rng(33)
    x = rng.standard_normal((500, 2))
    c = biquad.lowpass(np.array([800.0, 5000.0]), 0.707, SR)
    jc = jbq.lowpass(jnp.asarray([800.0, 5000.0]), 0.707, SR)
    ps, y = biquad.process(c, biquad.init_state((2,)), torch.from_numpy(x))
    js, jy = jbq.process(jc, jbq.init_state((2,)), jnp.asarray(x))
    assert_close("biquad.process", np_tree(jax.tree.map(
        lambda a: a.numpy(), (ps, y))), np_tree((js, jy)))


def test_diode_current_deriv_matches_reference():
    d = mna.DiodeModel(is_=2e-15, n=1.8)
    jd = jmna.DiodeModel(is_=2e-15, n=1.8)
    v = np.random.default_rng(34).uniform(-3.0, 1.5, 257)
    v[:3] = [0.0, 40.0 * 1.8 * d.vt, 1.2]   # 0, the limexp knee, past it
    i, g = gp.diode_current_deriv(d, torch.from_numpy(v))
    ji, jg = jgp.diode_current_deriv(jd, jnp.asarray(v))
    assert_close("diode_current_deriv", {"i": i.numpy(), "g": g.numpy()},
                 {"i": np.asarray(ji), "g": np.asarray(jg)})


# ── the reference tests' cases, on the port ──


def _crossings(buf):
    return int(((buf[:-1] < 0) & (buf[1:] >= 0)).sum())


def test_reed_render_damper_progressive_silence():
    """tests/test_reed_voice.py test_damper_progressive_silence (its
    `_render` helper is reed.render)."""
    amps = np.zeros(7)
    amps[0] = 1.0
    p = t_tree(reed.make_params(440.0, RATIOS, amps, np.zeros(7), 0.0, 1.0,
                                SR))
    s = t_tree(reed.init_state(reed.make_params(
        440.0, RATIOS, amps, np.zeros(7), 0.0, 1.0, SR), 42))
    s1, out1 = reed.render(p, s, 1000)
    assert abs(_crossings(out1.numpy()) - 440 * 1000 / SR) < 2
    s_damped = reed.start_damper(s1, torch.tensor(60.0), SR)
    s2, out2 = reed.render(p, s_damped, int(SR * 0.5))
    assert float(out2[-100:].abs().max()) < 0.02
    assert bool(reed.is_silent(p, s2, -30.0))


def test_biquad_bandpass():
    """tests/test_reed_voice.py test_biquad_bandpass."""
    n = int(SR * 0.1)
    t = np.arange(n) / SR
    coeffs = biquad.bandpass(1000.0, 1.0, SR)
    _, out_c = biquad.process(coeffs, biquad.init_state(),
                              torch.from_numpy(np.sin(2 * np.pi * 1000 * t)))
    _, out_l = biquad.process(coeffs, biquad.init_state(),
                              torch.from_numpy(np.sin(2 * np.pi * 100 * t)))
    pc = float(out_c[n // 2:].abs().max())
    pl = float(out_l[n // 2:].abs().max())
    assert pc > pl * 3.0


def _peak(x):
    return float(torch.as_tensor(x).abs().max())


@pytest.mark.parametrize("case", ["roundtrip", "passband"])
def test_oversampler_roundtrip(case):
    """tests/test_ops_speaker.py test_oversampler_roundtrip_preserves_signal
    (440 Hz, 1024 samples, ratio within 10 %) and
    test_oversampler_passband_flat (1 kHz, 4096 samples, within 0.5 dB
    over the last quarter)."""
    n, hz = (1024, 440.0) if case == "roundtrip" else (4096, 1000.0)
    x = torch.from_numpy(np.sin(2 * np.pi * hz * np.arange(n) / SR))
    st, up = allpass.upsample_2x(allpass.init_state(), x)
    assert up.shape == (2 * n,)
    st, down = allpass.downsample_2x(st, up)
    if case == "roundtrip":
        assert abs(_peak(down[n // 2:]) / _peak(x[n // 2:]) - 1.0) < 0.1
    else:
        start = n * 3 // 4
        assert abs(20 * np.log10(_peak(down[start:]) / _peak(x[start:]))) \
            < 0.5


def test_oversampler_stopband_rejection():
    """tests/test_ops_speaker.py test_oversampler_stopband_rejection."""
    n = 4096
    up = torch.from_numpy(np.sin(2 * np.pi * 30000.0 * np.arange(2 * n)
                                 / 88200.0))
    _, down = allpass.downsample_2x(allpass.init_state(), up)
    atten_db = 20 * np.log10(_peak(down[n // 2:]) / _peak(up[n:]))
    assert atten_db < -20.0, f"{atten_db:.1f} dB"


def test_oversampler_batched():
    """tests/test_ops_speaker.py test_oversampler_batched."""
    n = 256
    t = np.arange(n) / SR
    x = np.stack([np.sin(2 * np.pi * 440.0 * t),
                  np.sin(2 * np.pi * 880.0 * t)], axis=1)
    st, up = allpass.upsample_2x(allpass.init_state((2,)),
                                 torch.from_numpy(x))
    assert up.shape == (2 * n, 2)
    _, down = allpass.downsample_2x(st, up)
    assert down.shape == (n, 2)
    assert bool(torch.isfinite(down).all())


def test_diode_deriv():
    """tests/test_gp.py test_diode_deriv: the current against
    mna.diode_current at rtol 1e-12, the conductance against autograd of
    it at rtol 1e-9."""
    d = mna.DiodeModel(is_=2e-15, n=1.8)
    v = torch.linspace(-2.0, 1.0, 101, dtype=torch.float64)
    i, g = gp.diode_current_deriv(d, v)
    np.testing.assert_allclose(i.numpy(), mna.diode_current(d, v).numpy(),
                               rtol=1e-12)
    vg = v.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(mna.diode_current(d, vg).sum(), vg)
    np.testing.assert_allclose(g.numpy(), g_ad.numpy(), rtol=1e-9)
