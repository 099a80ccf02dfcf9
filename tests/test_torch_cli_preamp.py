"""The CLI's preamp and pump measurements in the PyTorch port (kernel E7's
plain version, `kernels/render.py` `dk_scan_plain`) against the JAX
package's `openwurli_tpu.cli` (CPU, float64).

  * `_measure_preamp_gain_batch` at 3 frequencies × 2 R_ldr, settle and
    measure 10 ms each at 88.2 kHz. Target: |Δgain| ≤ 1e-6 dB.
  * `harmonics`' H1-H5 (the reference's `cmd_harmonics` scan and DFT,
    over the same 20 ms window instead of its 0.5 s). Target: 1e-6 dB.
  * `_pump_trace` under `pump-sinusoid`'s R_ldr law (R_ldr changes every
    sample), 2000 steps, and a grid of three fixed R_ldr. Target: 1e-12 of
    the trace's peak.
  * Streams fed NaN and inf inputs and a NaN resistance: both taps of the
    scan against the reference's scan body, which resets the twin to its
    DC point; exact zeros and DC values where the reference has them, the
    rest at the targets above (1e-6 dB of the peak, i.e. 1.2e-7 relative,
    for main − shadow).
  * The printed lines of `pump-spike` and `sweep` at a 2-4 kHz rate: the
    same text from both CLIs.
  * E7's wrapper rejects an unknown tap, mismatched shapes, float32 and
    other devices; zero input at the quiescent R_ldr stays at the DC point.

The DK step carries XLA's multiply-add contractions in the reference
(ROADMAP queue 3), in the main − shadow difference and in the shadow's own
node update, so a measurement that misses its target is gated at the
reference's own response to a 1-ulp perturbation of the DK state entering
every step (two seeds, the larger), + 3 dB.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import cli as jcli
from openwurli_tpu.calib import goertzel as jgoertzel
from openwurli_tpu.circuits import dk_preamp as jdk
from openwurli_tpu_torch import cli
from openwurli_tpu_torch.kernels import render as kr

torch.set_num_threads(1)

SR = 88200.0
GAIN_DB = 1e-6
PUMP_REL = 1e-12
GATE_DB = 3.0


def _db(a, b):
    return np.abs(20.0 * np.log10(np.asarray(a) / np.asarray(b)))


@contextlib.contextmanager
def _nudged_dk(seed):
    """`openwurli_tpu.circuits.dk_preamp.step` with the state entering
    every step moved by one ulp, in directions drawn from `seed` and the
    bits of the state and the input."""
    step, key0 = jdk.step, jax.random.PRNGKey(seed)

    def nudged(params, pre, g, x):
        bits = jax.lax.bitcast_convert_type(
            jnp.concatenate([pre.v.ravel(), jnp.ravel(x)]), jnp.uint32)
        key = jax.random.fold_in(key0, jnp.sum(bits, dtype=jnp.uint32))
        leaves, tdef = jax.tree.flatten(pre)
        keys = jax.random.split(key, len(leaves))
        pre = jax.tree.unflatten(tdef, [
            jnp.nextafter(a, jnp.where(jax.random.bernoulli(k, 0.5, a.shape),
                                       jnp.inf, -jnp.inf))
            for a, k in zip(leaves, keys)])
        return step(params, pre, g, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdk, "step", nudged)
        yield


def _assert_gated(name, err, twin_errs, target):
    """err within target, or within the larger twin's error + GATE_DB."""
    twin = np.max(twin_errs, axis=0)
    gate = np.maximum(target, twin * 10 ** (GATE_DB / 20))
    print(f"{name}: port {np.max(err):.3g}, twin {np.max(twin):.3g}, "
          f"target {target:.3g}")
    assert (err <= gate).all(), (name, err, gate)


def test_gain_batch_matches_reference():
    freqs = np.repeat([100.0, 1000.0, 10_000.0], 2)
    r_ldrs = np.tile([1_000_000.0, 19_000.0], 3)
    calls = kr.DK_SCAN_PLAIN_CALLS, dict(kr.DK_SCAN_LAUNCHES)
    port = cli._measure_preamp_gain_batch(freqs, 0.001, r_ldrs, SR, 0.01,
                                          0.01, device="cpu")
    assert kr.DK_SCAN_PLAIN_CALLS == calls[0] + 1
    assert kr.DK_SCAN_LAUNCHES == calls[1]
    ref = jcli._measure_preamp_gain_batch(freqs, 0.001, r_ldrs, SR, 0.01,
                                          0.01)
    assert port.shape == (6,)
    twins = []
    for seed in (1, 2):
        with _nudged_dk(seed):
            twins.append(_db(jcli._measure_preamp_gain_batch(
                freqs, 0.001, r_ldrs, SR, 0.01, 0.01), ref))
    print(f"gains {20 * np.log10(ref).round(3)} dB")
    _assert_gated("gain (dB)", _db(port, ref), twins, GAIN_DB)
    # the LDR shunt lowers the gain at every frequency
    assert (port[1::2] < port[::2]).all()


def _jax_harmonics(freq, amplitude, r_ldr, sr, n):
    """`openwurli_tpu.cli.cmd_harmonics`' scan and DFT over n samples."""
    params = jdk.make_params(sr)
    g = jdk.ldr_conductance(r_ldr)
    t = np.arange(n) / sr
    xs = jnp.asarray(amplitude * np.sin(2 * np.pi * freq * t))

    @jax.jit
    def run(state, xs):
        return jax.lax.scan(lambda st, x: jdk.step(params, st, g, x), state,
                            xs)

    _, out = run(jdk.init_state(params), xs)
    return np.asarray(jgoertzel.dft_magnitude(
        out[n // 2:], jnp.asarray([freq * k for k in (1, 2, 3, 4, 5)]), sr))


def test_harmonics_match_reference():
    port = cli.harmonic_mags(440.0, 0.005, 1_000_000.0, SR, seconds=0.02,
                             device="cpu")
    args = (440.0, 0.005, 1_000_000.0, SR, int(SR * 0.02))
    ref = _jax_harmonics(*args)
    twins = []
    for seed in (1, 2):
        with _nudged_dk(seed):
            twins.append(_db(_jax_harmonics(*args), ref))
    print(f"H1-H5 levels {20 * np.log10(ref).round(2)} dB")
    _assert_gated("H1-H5 (dB)", _db(port, ref), twins, GAIN_DB)


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


def _twins(fn, ref, err):
    """err(fn(), ref) of the reference under both nudge seeds."""
    out = []
    for seed in (1, 2):
        with _nudged_dk(seed):
            out.append(err(fn(), ref))
    return out


@pytest.mark.parametrize("law", ["sinusoid", "grid"])
def test_pump_trace_matches_reference(law):
    if law == "sinusoid":    # R_ldr changes every sample
        r_fn, n, shape = cli.sinusoid_r_ldr(9_000.0, 1_000_000.0, 5.5), \
            2000, (2000,)
    else:                    # one stream per R_ldr, advanced in one scan
        rs = np.array([30_000.0, 47_500.0, 1_000_000.0])
        r_fn, n, shape = (lambda t: np.broadcast_to(rs, (len(t), 3))), 300, \
            (300, 3)
    port = cli._pump_trace(r_fn, n / SR, SR, device="cpu")
    ref = jcli._pump_trace(r_fn, n / SR, SR)
    assert port.shape == ref.shape == shape
    twins = _twins(lambda: jcli._pump_trace(r_fn, n / SR, SR), ref, _rel)
    print(f"peak {np.abs(ref).max():.4f} V")
    _assert_gated("pump trace (of its peak)", _rel(port, ref), twins,
                  PUMP_REL)


def _jax_scan_both_taps(x, r, sr):
    """The reference's scan bodies of `_measure_preamp_gain_batch`
    (main − shadow) and `_pump_trace` (the shadow's OUT after the step),
    with a resistance per sample."""
    params = jdk.make_params(sr)

    @jax.jit
    def run(state, xr):
        def body(st, xr_t):
            st, y = jdk.step(params, st, jdk.ldr_conductance(xr_t[1]),
                             xr_t[0])
            return st, (y, st.v[..., 1, jdk.OUT])

        return jax.lax.scan(body, state, xr)

    st, (diff, shadow) = run(jdk.init_state(params, batch_shape=x.shape[1:]),
                             jnp.stack([jnp.asarray(x), jnp.asarray(r)], 1))
    return np.asarray(diff), np.asarray(shadow), st


def test_non_finite_inputs_reset_like_reference():
    n, g = 120, 4
    t = np.arange(n)[:, None]
    x = 0.003 * np.sin(np.array([0.02, 0.05, 0.11, 0.3]) * t)
    r = np.exp(np.linspace(np.log(800.0), np.log(2e6), n))[:, None] \
        * np.ones(g)
    x[30, 0] = np.nan
    x[60:, 1] = np.inf
    r[45, 2] = np.nan
    ref_diff, ref_shadow, ref_st = _jax_scan_both_taps(x, r, SR)
    outs = {}
    for tap in kr.DK_TAPS:
        st = kr.init_dk_scan_state(SR, g)
        outs[tap] = kr.dk_scan(SR, torch.as_tensor(x), torch.as_tensor(r),
                               st, tap).numpy()
    # the reset: exact zeros out and the shadow at its DC point
    v_dc = jdk.make_params(SR).v_dc[jdk.OUT]
    assert ref_diff[30, 0] == outs["diff"][30, 0] == 0.0
    assert (outs["diff"][60:, 1] == 0.0).all()
    assert (outs["shadow"][60:, 1] == v_dc).all()
    assert (ref_shadow[60:, 1] == v_dc).all()
    assert outs["shadow"][45, 2] == ref_shadow[45, 2] == v_dc
    twins = []
    for seed in (1, 2):
        with _nudged_dk(seed):
            twins.append(_jax_scan_both_taps(x, r, SR)[:2])
    for k, (tap, ref) in enumerate((("diff", ref_diff),
                                    ("shadow", ref_shadow))):
        port = outs[tap]
        assert np.isfinite(port).all() and np.isfinite(ref).all(), tap
        target = PUMP_REL if tap == "shadow" else 1 - 10 ** (-GAIN_DB / 20)
        _assert_gated(f"{tap} (of its peak)", _rel(port, ref),
                      [_rel(t[k], ref) for t in twins], target)
    # the end state: finite, the twin axis first in the port
    st = kr.init_dk_scan_state(SR, g)
    kr.dk_scan(SR, torch.as_tensor(x), torch.as_tensor(r), st, "diff")
    v = kr._pre_unrows(st).v.numpy()
    assert np.isfinite(v).all()
    assert np.abs(v[1, :, jdk.OUT] - np.asarray(ref_st.v)[:, 1, jdk.OUT]
                  ).max() <= 1e-9 * np.abs(v).max()


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["pump-spike", "--sr", "2000"],
    ["sweep", "--sr", "4000", "--hi", "1500", "--points", "4"],
])
def test_cli_prints_match_reference(argv):
    port = _stdout(cli.main, ["--device", "cpu", *argv])
    ref = _stdout(jcli.main, argv)
    print(port)
    assert port == ref
    assert len(port.splitlines()) == {"pump-spike": 42, "sweep": 5}[argv[0]]


def test_dk_scan_rejects_bad_inputs():
    x = torch.zeros((8, 3), dtype=torch.float64)
    st = kr.init_dk_scan_state(SR, 3)
    assert st.shape == (kr.PRE_ROWS, 3) == (29, 3)
    with pytest.raises(ValueError, match="tap"):
        kr.dk_scan(SR, x, x, st, "main")
    with pytest.raises(ValueError):
        kr.dk_scan(SR, x, x[:, :2].contiguous(), st, "diff")
    with pytest.raises(ValueError):
        kr.dk_scan(SR, x, x, st[:, :2].contiguous(), "diff")
    with pytest.raises(TypeError):
        kr.dk_scan(SR, x.float(), x, st, "diff")
    with pytest.raises(ValueError, match="unsupported device"):
        kr.dk_scan(SR, x.to("meta"), x.to("meta"), st.to("meta"), "diff")
    # zero input at the quiescent resistance: the twin stays at its DC point
    out = kr.dk_scan(SR, x, torch.full_like(x, jdk.R_LDR_INIT), st, "shadow")
    v_dc = float(jdk.make_params(SR).v_dc[jdk.OUT])
    assert np.abs(out.numpy() - v_dc).max() < 1e-9
