"""Stage gates of the PyTorch port's chain step functions (the plain
float32 versions that the CUDA kernel K2 mirrors op for op) against the
float64 circuit modules of the JAX package: the gates that
`tests/test_mono_chain.py` holds the JAX step functions to, on the same
signals.

  * preamp over a tremolo-swept render: −64 dB;
  * preamp through the junction turn-on at the tremolo crest: −60 dB;
  * power amp at amplitudes 0.05 and 0.2: −70 dB each (both amplitudes go
    through one loop as two streams; 3000 oversampled samples instead of
    the reference test's 4000, to fit the test budget, same window start);
  * subsampled tremolo: median shunt deviation below 2 % and the same
    oscillation rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.circuits import dk_preamp as dkp
from openwurli_tpu.circuits import power_amp as pamod
from openwurli_tpu.circuits import tremolo as trmod
from openwurli_tpu_torch.kernels import mono_chain as pmc

torch.set_num_threads(1)

BASE_SR = 44100.0
OS_SR = 2 * BASE_SR


def _db(err, sig):
    return 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30)
                           / np.sqrt(np.mean(sig ** 2)))


def _port_env(n_streams=1, **controls):
    consts = pmc.pack_consts(BASE_SR)
    ctrl = pmc.make_controls(BASE_SR, n_streams, **controls)
    st = {k: v.clone() for k, v in
          pmc.unpack_state(pmc.init_state(BASE_SR, n_streams)).items()}
    return pmc.chain_tensors(consts, ctrl), pmc.scalar_tensors(consts), st


def _preamp_f64(u, gl):
    pp = dkp.make_params(OS_SR)

    def body(st, xs):
        g, x = xs
        return dkp.step(pp, st, g, x)

    _, y = jax.lax.scan(body, dkp.init_state(pp),
                        (jnp.asarray(gl), jnp.asarray(u, jnp.float64)))
    return np.asarray(y)


def _preamp_port(u, gl):
    c, sc, st = _port_env()
    u = torch.from_numpy(u.astype(np.float32)).reshape(-1, 1, 1)
    g = torch.from_numpy(gl.astype(np.float32)).reshape(-1, 1, 1)
    out = np.empty(u.shape[0], np.float32)
    with torch.inference_mode():
        for i in range(u.shape[0]):
            st, y = pmc.preamp_step(c, sc, st, u[i], g[i])
            out[i] = y.item()
    return out


def test_preamp_stage_parity():
    t = np.arange(3000) / OS_SR
    u = 0.05 * np.sin(2 * np.pi * 1000 * t)
    r = 12000 + 8000 * np.sin(2 * np.pi * 5.5 * t)
    gl = 1.0 / np.maximum(r, 1000)
    y64 = _preamp_f64(u.astype(np.float32), gl)
    y32 = _preamp_port(u, gl)
    db = _db((y32 - y64)[200:], y64[200:])
    print(f"preamp stage parity {db:.1f} dB")
    assert db < -64.0, f"preamp stage parity {db:.1f} dB"


def test_preamp_crest_turn_on_parity():
    t = np.arange(6000) / OS_SR
    u = 0.12 * (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 440 * t))
    r = 31000.0 + 3800.0 * np.sin(2 * np.pi * 5.5 * t)
    gl = 1.0 / np.maximum(r, 1000)
    y64 = _preamp_f64(u.astype(np.float32), gl)
    y32 = _preamp_port(u, gl)
    db = _db((y32 - y64)[400:], y64[400:])
    print(f"preamp crest turn-on parity {db:.1f} dB")
    assert db < -60.0, f"preamp crest turn-on parity {db:.1f} dB"


PA_AMPS = (0.05, 0.2)
PA_LEN = 3000


@pytest.fixture(scope="module")
def power_amp_runs():
    t = np.arange(PA_LEN) / OS_SR
    env = np.minimum(np.arange(PA_LEN) / 400.0, 1.0)
    u64 = np.stack([env * amp * np.sin(2 * np.pi * 1000 * t)
                    for amp in PA_AMPS], axis=1)          # (T, 2)

    pa = pamod.make_params(OS_SR)

    def body(st, x):
        return pamod.step(pa, st, x, rail_sag=True)

    y64 = np.stack([np.asarray(jax.lax.scan(
        body, pamod.init_state(pa), jnp.asarray(u64[:, k]))[1])
        for k in range(len(PA_AMPS))], axis=1)

    c, sc, st = _port_env(len(PA_AMPS))
    x = torch.from_numpy(u64.astype(np.float32))[:, None, :]
    sag = torch.ones((1, len(PA_AMPS)))
    y32 = np.empty((PA_LEN, len(PA_AMPS)), np.float32)
    with torch.inference_mode():
        for i in range(PA_LEN):
            st, y = pmc.pa_step(c, sc, st, x[i], sag)
            y32[i] = y[0].numpy()
    return y64, y32


@pytest.mark.parametrize("k", range(len(PA_AMPS)))
def test_power_amp_stage_parity(power_amp_runs, k):
    y64, y32 = power_amp_runs
    db = _db((y32[:, k] - y64[:, k])[500:], y64[500:, k])
    print(f"power amp parity {db:.1f} dB at amp={PA_AMPS[k]}")
    assert db < -70.0, f"power amp parity {db:.1f} dB at amp={PA_AMPS[k]}"


def test_tremolo_subsampled_parity():
    """The subsampled tremolo against the per-sample float64 oscillator:
    the shunt trajectory within 2 % (median) and the same number of mean
    crossings."""
    n_upd = 3000  # × TREM_SUB_OS oversampled samples, about 0.27 s
    tp = trmod.make_params(OS_SR)

    def body(st, _):
        return trmod.step(tp, st, 0.5)

    _, shunt64 = jax.lax.scan(body, trmod.init_state(OS_SR), None,
                              length=n_upd * pmc.TREM_SUB_OS)
    shunt64 = np.asarray(shunt64)[pmc.TREM_SUB_OS - 1::pmc.TREM_SUB_OS]

    c, sc, st = _port_env(depth=0.5)
    shunt32 = np.empty(n_upd)
    with torch.inference_mode():
        for i in range(n_upd):
            st = pmc.trem_update(c, sc, st)
            shunt32[i] = 1.0 / st["gldr_cur"].item()
    s64, s32 = shunt64[n_upd // 2:], shunt32[n_upd // 2:]
    rel = np.abs(s32 - s64) / np.abs(s64)
    print(f"tremolo median shunt deviation {np.median(rel):.2e}")
    assert np.median(rel) < 0.02, f"median shunt deviation {np.median(rel)}"
    m64 = (s64 > s64.mean()).astype(int)
    m32 = (s32 > s32.mean()).astype(int)
    assert abs(np.abs(np.diff(m64)).sum() - np.abs(np.diff(m32)).sum()) <= 2
