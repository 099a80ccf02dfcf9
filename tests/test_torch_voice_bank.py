"""Voice bank (K1) of the PyTorch port: its plain version against the JAX
kernel in interpret mode on the same packed params, against the f64 voice
scan, and the kernel's own invariants (padding, steady gating, carried
state).

State comparison: the LCG rows must be bit-identical. The float rows are
held to 5e-5 of each row's peak: the reference's interpret-mode program is
compiled by XLA, which fuses multiply-adds and uses its own f32
transcendentals, so the rotation state differs from the port's eager
float32 rounding by up to 1.4e-5 of the row's peak (about 2e2 ulp) after
4096 samples — the reference's own gate for this is 2 ulp, missed and
recorded in ROADMAP queue 3 — while the output agrees to about −100 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import voice
from openwurli_tpu.kernels import voice_bank as vb
from openwurli_tpu_torch import convert
from openwurli_tpu_torch.kernels import voice_bank as pvb

torch.set_num_threads(1)

SR = 44100.0
NOTES = [48.0, 60.0, 69.0, 84.0]
VELS = [0.95, 0.8, 0.6, 0.9]


def _peak_db(got, ref):
    return 20 * np.log10(max(np.abs(got - ref).max(), 1e-300)
                         / np.abs(ref).max())


@pytest.fixture(scope="module")
def reference():
    params, n_active = vb.make_kernel_params(NOTES, VELS, SR)
    steady = vb.steady_limits(params)
    out, st = vb.render_voice_bank(params, 4096, True, steady=steady,
                                   return_state=True)
    return np.asarray(params), n_active, steady, np.asarray(out), \
        np.asarray(st)


@pytest.fixture(scope="module")
def port(reference):
    params, _n, steady, _o, _s = reference
    p = convert.voice_params_from_numpy(params)
    out, st = pvb.render_voice_bank(p, 4096, steady=steady,
                                    return_state=True)
    return out.numpy(), st.numpy()


def test_plain_matches_jax_kernel(reference, port):
    _p, n_active, _s, ref_out, _st = reference
    out, _ = port
    for k in range(n_active):
        db = _peak_db(out[:, k], ref_out[:, k])
        assert db < -80.0, f"voice {k} (midi {NOTES[k]}): {db:.1f} dB"


def test_state_matches_jax_kernel(reference, port):
    ref_st = reference[4]
    _, st = port
    assert np.array_equal(ref_st[40:48].view(np.uint32),
                          st[40:48].view(np.uint32))
    scale = np.maximum(np.abs(ref_st[:40]).max(axis=1, keepdims=True),
                       1e-30)
    rel = np.abs(st[:40].astype(np.float64) - ref_st[:40]) / scale
    assert rel.max() < 5e-5, rel.max(axis=1)


def test_note69_against_f64_scan():
    n = 4096
    params, _ = pvb.make_kernel_params([69.0], [0.8], SR)
    out = pvb.render_voice_bank(params, n).numpy()[:, 0]
    ref = np.asarray(voice.render_note(jnp.asarray([69.0]),
                                       jnp.asarray([0.8]), n / SR, SR))[:, 0]
    db = _peak_db(out, ref)
    assert db < -60.0, f"port voice vs f64 scan {db:.1f} dB"


def test_padding_lanes_are_silent():
    params, n_active = pvb.make_kernel_params([60.0], [0.8], SR)
    out = pvb.render_voice_bank(params, 600).numpy()
    assert np.abs(out[:, n_active:]).max() == 0.0
    assert np.abs(out[:, 0]).max() > 0.0


def test_steady_gating_is_bit_exact():
    params, _ = pvb.make_kernel_params([48.0, 69.0], [0.9, 0.7], SR)
    steady = pvb.steady_limits(params)
    a = pvb.render_voice_bank(params, 4096).numpy()
    b = pvb.render_voice_bank(params, 4096, steady=steady).numpy()
    assert np.array_equal(a, b), np.abs(a - b).max()


def test_state_carry_blocks_are_bit_exact():
    params, _ = pvb.make_kernel_params([55.0, 70.0], [0.85, 0.75], SR)
    whole = pvb.render_voice_bank(params, 4096).numpy()
    a, st = pvb.render_voice_bank(params, 2048, return_state=True)
    b = pvb.render_voice_bank(params, 2048, state=st, n0=2048)
    stitched = np.concatenate([a.numpy(), b.numpy()])
    assert np.array_equal(whole, stitched), np.abs(whole - stitched).max()


def test_plain_counter_counts_cpu_calls():
    params, _ = pvb.make_kernel_params([60.0], [0.8], SR)
    before = (pvb.PLAIN_CALLS, pvb.KERNEL_LAUNCHES)
    pvb.render_voice_bank(params, 64)
    assert (pvb.PLAIN_CALLS, pvb.KERNEL_LAUNCHES) == (before[0] + 1,
                                                      before[1])
