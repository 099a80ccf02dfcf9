"""`voice.render_note` of the PyTorch port against the JAX package's (CPU,
float64, kernel E4's plain version), and the reference's voice gates.

  * A grid of 3 notes with the MLP off and on, each voice within -120 dB
    RMS of the reference's; a single note equals its column of the grid
    to 1e-12 (the reference's own gate).
  * The reference's voice gates (tests/test_reed_voice.py), on the port
    alone.
  * `voice.render` returns the voices' end state.

The DI preamp is tests/test_torch_di_preamp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import voice as jvoice
from openwurli_tpu_torch import voice
from openwurli_tpu_torch.kernels import engine as ek
from openwurli_tpu_torch.kernels import render as kr

torch.set_num_threads(1)

SR = 44100.0
TARGET_DB = -120.0


def _db(port, ref):
    """Per-voice error RMS over the reference's RMS, in dB (columns)."""
    rms = np.sqrt(np.mean(ref ** 2, axis=0))
    err = np.sqrt(np.mean((port - ref) ** 2, axis=0))
    with np.errstate(divide="ignore", invalid="ignore"):
        return 20 * np.log10(err / rms)


@pytest.mark.parametrize("mlp", [False, True], ids=["mlp_off", "mlp_on"])
def test_render_note_matches_reference(mlp):
    m, v = np.array([40.0, 60.0, 72.0]), np.array([0.9, 0.5, 0.2])
    ref = np.asarray(jvoice.render_note(jnp.asarray(m), jnp.asarray(v), 0.05,
                                        SR, mlp_enabled=mlp))
    out = voice.render_note(m, v, 0.05, SR, mlp_enabled=mlp, device="cpu")
    assert out.dtype == torch.float64 and out.shape == ref.shape == (2205, 3)
    db = _db(out.numpy(), ref)
    print(f"render_note mlp={mlp}: {db.round(1)} dB")
    assert (db < TARGET_DB).all(), db
    single = voice.render_note(60.0, 0.5, 0.05, SR, mlp_enabled=mlp,
                               device="cpu").numpy()
    assert single.shape == (2205,)
    np.testing.assert_allclose(single, out[:, 1].numpy(), rtol=0, atol=1e-12)


# ── the reference's voice gates (tests/test_reed_voice.py), port alone ──


def _render(m, v, dur):
    return voice.render_note(m, v, dur, SR, device="cpu").numpy()


def test_render_note_produces_audio():
    out = _render(60, 0.8, 0.25)
    assert np.abs(out).max() > 0.0 and np.isfinite(out).all()


def test_higher_velocity_is_louder():
    out = _render(np.array([60.0, 60.0]), np.array([0.3, 1.0]), 0.1)
    assert np.abs(out[:, 1]).max() > np.abs(out[:, 0]).max()


def test_voice_deterministic():
    np.testing.assert_array_equal(_render(60, 0.8, 0.1),
                                  _render(60, 0.8, 0.1))


def test_different_notes_differ():
    out = _render(np.array([60.0, 72.0]), np.array([0.8, 0.8]), 0.1)
    assert np.abs(out[:, 0] - out[:, 1]).max() > 0


def test_batched_matches_single():
    grid = _render(np.array([48.0, 60.0, 72.0]), np.array([0.8] * 3), 0.05)
    np.testing.assert_allclose(grid[:, 1], _render(60, 0.8, 0.05), rtol=0,
                               atol=1e-12)


def test_voice_note_off_silences():
    vp, det = voice.note_on_params(60, 0.8, SR, mlp_enabled=False)
    st = voice.init_state(vp, det, 0.8, SR, voice.default_note_seed(60))
    vpar, vst, vsti = kr.voice_columns(vp, st)
    kr.voice_render(vpar, vst, vsti, 2000)
    params, state = ek.unpack_voices(vpar, vst, vsti)
    ek.write_voice_state(vst, vsti, voice.note_off(params, state, SR))
    out = kr.voice_render(vpar, vst, vsti, int(SR * 0.5)).numpy()
    assert np.abs(out[-1000:]).max() < 1e-4


def test_render_returns_the_end_state():
    vp, det = voice.note_on_params(np.array([[60.0, 64.0]]),
                                   np.array([[0.8, 0.6]]), SR)
    st = voice.init_state(vp, det, np.array([[0.8, 0.6]]), SR,
                          voice.default_note_seed(np.array([[60, 64]])))
    end, out = voice.render(vp, st, 100, device="cpu")
    assert out.shape == (100, 1, 2)
    assert isinstance(end, voice.VoiceState)
    assert end.reed.n.tolist() == [[100, 100]]
    assert end.reed.s.shape == (1, 2, 7)
    # the end state goes on where the render stopped
    _, tail = voice.render(vp, end, 50, device="cpu")
    _, whole = voice.render(vp, st, 150, device="cpu")
    assert torch.equal(tail, whole[100:])
