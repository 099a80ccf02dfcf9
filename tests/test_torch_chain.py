"""The PyTorch port's mono chain (K2, plain version) over whole renders:
against the reference's scan twin `render_cpu` and against the f64 module
chain, on the quick signal of `test_quick_gates.py`.

Gates: −45 dB relative RMS after sample 400 for both, on the signal's
first 1024 samples — the JAX package's own kernel-against-f64 gate for
this signal. The −80 dB port-against-
`render_cpu` target is missed: the chain's free trajectory amplifies the
ulp-level rounding differences between XLA's compiled float32 and the
port's eager float32 (first seen in the first preamp Newton solve) to
about −50 dB (recorded in ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import mono_chain as pmc
from test_mono_chain import _db, _f64_chain, _loud_test_signal

torch.set_num_threads(1)

BASE_SR = 44100.0
DEPTH = np.array([0.0, 0.5, 1.0])
CHAR = np.array([0.0, 0.0, 1.0])
F64_STREAM = 1  # depth 0.5, character 0: the f64 reference's setting
# The quick signal's first 1024 samples (the reference's gate uses 2048):
# the gate window starts after its 400-sample ramp, and the plain chain's
# Python loop sets the file's run time.
T_CHAIN = 1024


def quick_signal(t_len=T_CHAIN, lvl=0.05):
    tt = np.arange(t_len) / BASE_SR
    env = np.minimum(np.arange(t_len) / 400.0, 1.0)
    return (env * lvl * (np.sin(2 * np.pi * 220 * tt)
                         + 0.5 * np.sin(2 * np.pi * 440 * tt))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def renders():
    audio = np.repeat(quick_signal()[:, None], 3, axis=1)
    kw = dict(volume=0.5, depth=DEPTH, character=CHAR)
    ref, _ = mc.render_cpu(mc.pack_consts(BASE_SR),
                           mc.make_controls(BASE_SR, 3, **kw),
                           mc.init_state(BASE_SR, 3), audio)
    got, st = pmc.render(BASE_SR, pmc.make_controls(BASE_SR, 3, **kw),
                         pmc.init_state(BASE_SR, 3),
                         torch.from_numpy(audio))
    return np.asarray(ref), got.numpy(), st


def test_chain_against_render_cpu(renders):
    ref, got, _ = renders
    for s in range(3):
        db = _db((got[:, s] - ref[:, s])[400:], ref[400:, s])
        print(f"stream {s}: port vs render_cpu {db:.2f} dB")
        assert db < -45.0, f"stream {s}: {db:.1f} dB against render_cpu"


def test_chain_against_f64(renders):
    _, got, _ = renders
    y64 = _f64_chain(quick_signal().astype(np.float64), depth=0.5,
                     volume=0.5, character=0.0)
    db = _db((got[:, F64_STREAM] - y64)[400:], y64[400:])
    print(f"port vs f64 chain {db:.2f} dB")
    assert db < -45.0, f"port chain vs f64 {db:.1f} dB"


def test_chain_state_is_finite_and_guard_quiet(renders):
    _, got, st = renders
    assert np.isfinite(got).all()
    a, _b = pmc._OFFSETS["guard_fires"]
    assert float(st[a].abs().max()) == 0.0


@pytest.mark.slow
def test_full_chain_parity_fixed_trajectory():
    """Port of the reference's fixed-trajectory gate: with the tremolo
    trajectory bit-matched, the port's base_step tracks the f64 chain to
    −60 dB relative / −62 dBFS at loud drive."""
    t_len = 8192
    audio = _loud_test_signal(t_len)
    r = 12000 + 8000 * np.sin(2 * np.pi * 5.5 * np.arange(t_len) / BASE_SR)
    g = (1.0 / np.maximum(r, 1000.0)).astype(np.float32)
    y64 = _f64_chain(audio.astype(np.float64), depth=0.5, volume=0.5,
                     character=0.0, gldr_seq=g.astype(np.float64))

    consts = pmc.pack_consts(BASE_SR)
    c = pmc.chain_tensors(consts, pmc.make_controls(
        BASE_SR, 1, volume=0.5, depth=0.5, character=0.0))
    sc = pmc.scalar_tensors(consts)
    st = pmc.unpack_state(pmc.init_state(BASE_SR, 1))
    y = np.empty(t_len, np.float32)
    with torch.inference_mode():
        for i in range(t_len):
            gv = torch.full((1, 1), float(g[i]))
            st = dict(st, gldr_cur=gv, gldr_upd_prev=gv,
                      trem_phase=torch.zeros((1, 1)))
            st, out = pmc.base_step(c, sc, st,
                                    torch.tensor([[float(audio[i])]]))
            y[i] = float(out)
    err = (y - y64)[1000:]
    db = _db(err, y64[1000:])
    err_dbfs = 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30))
    assert db < -60.0, f"fixed-trajectory parity {db:.1f} dB"
    assert err_dbfs < -62.0, f"fixed-trajectory abs {err_dbfs:.1f} dBFS"


def test_controls_match_reference_layout():
    ref = mc.make_controls(BASE_SR, 3, depth=DEPTH, character=CHAR)
    got = pmc.make_controls(BASE_SR, 3, depth=DEPTH, character=CHAR)
    assert np.array_equal(np.asarray(ref), got.numpy())
    assert jnp.asarray(ref).shape == (pmc.CTRL_ROWS, 3)
