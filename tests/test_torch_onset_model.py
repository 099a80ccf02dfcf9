"""The onset/pitch network (`calib.onset_model`) and the note extractors
(`calib.notes.extract_notes`) in the PyTorch port against the JAX
package's (CPU).

The shipped weights (`data/onset_pitch.npz`, a byte copy of the reference
package's file) predate the network's format 3: they lack the `fmt` tag,
so both packages' `load_params()` return None, `nn_extract_notes` finds
nothing and `extract_notes(method="auto")` takes the spectral path
(ROADMAP queue 1, slice 5b: retraining). The network is therefore held to
the reference on seeded format-3 parameters: `forward` on the features of
`tests/baselines/onset_test_clips.npz`, float32 with another sum order
(cuDNN/oneDNN convolutions against XLA's): logits within 1e-4 of their
peak (the gap measured on this CPU is printed); the decoder on one
probability map handed to both; `train` at the JAX test's settings (150
steps): the loss trajectory within 1e-3 relative, and l1 < 0.7·l0.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openwurli_tpu.calib import notes as jnotes
from openwurli_tpu.calib import onset_model as jom
from openwurli_tpu_torch import DATA_DIR, convert
from openwurli_tpu_torch.calib import notes, onset_model as om

torch.set_num_threads(1)

SR = 44100.0
FIXTURE = os.path.join(os.path.dirname(__file__), "baselines",
                       "onset_test_clips.npz")
ONSET_NPZ_SHA256 = \
    "333d19b2066a752d80cc4e9e01593c1ea6328ced99aa906612b1811360e933ea"
EVENTS = [(0.4, 48, 0.0), (1.6, 67, -6.0), (2.9, 48, -12.0),
          (4.1, 67, 0.0)]


def _mixture():
    """tests/test_onset_model.py:100-118: the fixture clips at staggered
    onsets and gains."""
    with np.load(FIXTURE) as z:
        clips = {48: z["note48"], 67: z["note67"]}
        sr = float(z["sr"])
    audio = np.zeros(int(6.0 * sr))
    for onset_s, midi, gain_db in EVENTS:
        seg = clips[midi].astype(np.float64).copy()
        n_f = int(0.05 * sr)
        seg[-n_f:] *= np.linspace(1.0, 0.0, n_f)
        i0 = int(onset_s * sr)
        n = min(len(seg), len(audio) - i0)
        audio[i0:i0 + n] += 10.0 ** (gain_db / 20.0) * seg[:n]
    audio += 1e-5 * np.random.default_rng(0).normal(size=len(audio))
    return audio, sr


def _score(found):
    """(hits, spurious) as tests/test_onset_model.py:120-129 counts them."""
    used, hits = set(), 0
    for onset_s, midi, _ in EVENTS:
        ok = [i for i, f in enumerate(found)
              if i not in used and abs(f["onset_s"] - onset_s) < 0.1
              and abs(f["midi_note"] - midi) <= 1]
        if ok:
            used.add(ok[0])
            hits += 1
    return hits, len(found) - len(used)


def _seeded_params(seed=0):
    """Format-3 params: init_params with every bias and the feature
    statistics drawn too."""
    p = om.init_params(seed)
    rng = np.random.default_rng(seed + 100)
    for k in ("c1b", "c2b", "h1b", "hob", "hnb"):
        p[k] = rng.normal(0, 0.3, p[k].shape).astype(np.float32)
    p["feat_mean"] = rng.normal(-4.0, 1.0, om.N_BINS).astype(np.float32)
    p["feat_std"] = rng.uniform(0.5, 2.0, om.N_BINS).astype(np.float32)
    return p


def test_shipped_weights_are_the_reference_file():
    path = os.path.join(DATA_DIR, "onset_pitch.npz")
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == ONSET_NPZ_SHA256
    ref = os.path.join(os.path.dirname(jom.__file__), "..", "data",
                       "onset_pitch.npz")
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    # both packages read it alike: no format-3 tag, no weights
    assert (om.load_params() is None) == (jom.load_params() is None)
    assert om.load_params() is None


def test_extractors_on_the_fixture_mixture_match_reference():
    audio, sr = _mixture()
    assert om.nn_extract_notes(audio, sr, min_duration=0.15,
                               device="cpu") == []
    for method in ("nn", "spectral", "auto"):
        port = notes.extract_notes(audio, sr, min_duration=0.15,
                                   method=method, device="cpu")
        ref = jnotes.extract_notes(audio, sr, min_duration=0.15,
                                   method=method)
        assert port == ref, method
        print(method, _score(port))
    # what the reference measures today: the spectral path finds 1 of 4
    # with 6 spurious, the network (no weights) nothing
    assert _score(notes.extract_notes(audio, sr, min_duration=0.15,
                                      method="spectral",
                                      device="cpu")) == (1, 6)


def test_forward_matches_reference():
    with np.load(FIXTURE) as z:
        feats = np.concatenate([om.features(z[k].astype(np.float64), SR)
                                for k in ("note48", "note67")])
    np.testing.assert_array_equal(
        feats, np.concatenate([jom.features(z.astype(np.float64), SR)
                               for z in (np.load(FIXTURE)["note48"],
                                         np.load(FIXTURE)["note67"])]))
    xs = om.context_windows(feats)
    np.testing.assert_array_equal(xs, jom.context_windows(feats))
    np.testing.assert_array_equal(om.harmonic_bins(), jom.harmonic_bins())
    p = _seeded_params()
    ol, nl = om.forward(convert.onset_params_from_numpy(p),
                        torch.from_numpy(xs))
    jol, jnl = jom.forward({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(xs))
    for name, a, b in (("onset", ol, jol), ("note", nl, jnl)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape == (len(xs), om.N_NOTES)
        gap = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        print(f"{name} logits: max gap {gap:.3g} of the peak "
              f"{np.max(np.abs(b)):.3g}")
        assert gap <= 1e-4, (name, gap)
    y_on = (np.random.default_rng(1).random(ol.shape) < 0.05)
    loss = om.loss_fn(convert.onset_params_from_numpy(p),
                      torch.from_numpy(xs), torch.from_numpy(
                          y_on.astype(np.float32)), torch.from_numpy(
                          (~y_on).astype(np.float32)))
    ref = jom.loss_fn({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(xs), jnp.asarray(y_on, jnp.float32),
                      jnp.asarray(~y_on, jnp.float32))
    assert abs(float(loss) - float(ref)) <= 1e-4 * abs(float(ref))


def test_decoder_matches_reference(monkeypatch):
    """nn_extract_notes' decoding on one probability map handed to both
    packages (their `predict` patched): peaks, ±1-semitone suppression,
    per-pitch gaps, presence confirmation."""
    audio, sr = _mixture()
    n = 500
    rng = np.random.default_rng(5)
    onset = rng.uniform(0, 0.3, (n, om.N_NOTES)).astype(np.float32)
    presence = rng.uniform(0, 0.4, (n, om.N_NOTES)).astype(np.float32)
    for frame, pitch, height in ((30, 12, 0.9), (31, 13, 0.7),
                                 (130, 31, 0.8), (135, 31, 0.95),
                                 (240, 12, 0.6), (350, 40, 0.99),
                                 (351, 20, 0.52)):
        onset[frame, pitch] = height
        presence[frame:frame + 40, pitch] = 0.9
    hop_s = om.frame_params(sr)[1] / sr
    monkeypatch.setattr(om, "predict", lambda *a, **k: (onset, presence,
                                                         hop_s))
    monkeypatch.setattr(jom, "predict", lambda *a, **k: (onset, presence,
                                                         hop_s))
    p = _seeded_params()
    port = om.nn_extract_notes(audio, sr, params=p, device="cpu")
    ref = jom.nn_extract_notes(audio, sr, params=p)
    assert port == ref and len(ref) >= 3


def test_training_matches_reference(monkeypatch):
    """tests/test_onset_model.py:41-63's settings; both trajectories."""
    rng = np.random.default_rng(1)
    n = 600
    x = rng.normal(size=(n, om.CONTEXT * om.N_BINS)).astype(np.float32)
    y_on = (rng.random((n, om.N_NOTES)) < 0.02).astype(np.float32)
    y_note = (rng.random((n, om.N_NOTES)) < 0.1).astype(np.float32)
    x[:, :om.N_NOTES] = y_on * 4.0
    x[:, om.N_BINS:om.N_BINS + om.N_NOTES] = y_note * 4.0

    port_losses, ref_losses = [], []
    loss_fn = om.loss_fn

    def recording_loss(*a, **k):
        loss = loss_fn(*a, **k)
        port_losses.append(float(loss.detach()))
        return loss

    monkeypatch.setattr(om, "loss_fn", recording_loss)
    params = om.train(x, y_on, y_note, steps=150, batch=256, seed=0,
                      device="cpu")
    monkeypatch.setattr(om, "loss_fn", loss_fn)
    real_jit = jax.jit

    def recording_jit(f, **kw):
        jf = real_jit(f, **kw)
        if getattr(f, "__name__", "") != "step":  # optax's own jits
            return jf

        def step(*a):
            out = jf(*a)
            ref_losses.append(float(out[2]))
            return out
        return step

    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", recording_jit)
        jom.train(x, y_on, y_note, steps=150, batch=256, seed=0)
    a, b = np.asarray(port_losses), np.asarray(ref_losses)
    assert a.shape == b.shape == (150,)
    gap = np.max(np.abs(a - b) / np.abs(b))
    print(f"loss trajectory: worst relative gap {gap:.3g}")
    assert gap <= 1e-3

    p0 = convert.onset_params_from_numpy(om.init_params(0))
    p1 = convert.onset_params_from_numpy(params)
    xt, yo, yn = (torch.from_numpy(v) for v in (x, y_on, y_note))
    l0 = float(om.loss_fn(p0, xt, yo, yn))
    l1 = float(om.loss_fn(p1, xt, yo, yn))
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < 0.7 * l0, (l0, l1)
    assert params["fmt"][0] == 3 and params["C1"].dtype == np.float32
