"""Thermal noise of the PyTorch port's mono chain (K5, plain version) on the
CPU, against the JAX package at 44.1 kHz (the preamp runs 2× oversampled,
88.2 kHz, the rate of the reference's ngspice noise validation).

Tolerances, each with its reason:
  * `nz_lcg` (LCG words): bit-identical. The integer part is exact.
  * `nz_w` (the draws × gain): ≤ 2 ulp. `un·(2/4294967295) − 1` is one
    multiply and one subtract in the port; XLA may contract it on the CPU.
  * one `preamp_step(noise=True)`: the step gate of
    tests/test_torch_mono_chain.py (the reference's own response to a
    2-ulp perturbation of its float state + 1e-6 of the row's magnitude).
  * output RMS at gain 1 in the ngspice band, 8.08 µV × 0.60-1.40: RMS
    around each stream's own mean over steps 3000-6000 of 96 streams (the
    reference's estimator over a shorter, wider run; the first 3000 steps
    are the settle of the draws' mean, which the stamp injects as a DC
    step). Measured 6.31 µV here and within 1 % of it in the JAX package.
  * gain 4 over gain 1 in 3.0-5.3, on the deviation ACROSS streams of one
    gain at each step. The per-stream estimator holds a rounding pattern
    of a few µV that is common to all streams and does not scale with the
    gain: at this length it reads 2.7 in the port and in the JAX package
    alike, the across-stream one 3.12.
  * the port's statistics against the JAX package's on the same seeds and
    gains: within 5 % (the two differ only in rounding; measured < 1 %).
  * streams decorrelated: |r| < 0.15 between first differences at 8×.
  * gain 0.0 with noise=True: output and every non-`nz_` state row
    bit-identical to noise=False, through `mc.render`.
  * `render(noise=True)` against `render_cpu(noise=True)`: no worse than
    the reference's own worst 1-ulp twin + 3 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu_torch import convert, fast
from openwurli_tpu_torch.kernels import mono_chain as pmc

torch.set_num_threads(1)

SR = 44100.0
ANCHOR_RMS = 8.08e-6
G_LDR = 1.0 / 100_000.0       # the nominal 100 kOhm LDR point
N_STEPS, N_SETTLE = 6000, 3000
GAINS = np.concatenate([[1.0] * 96, [4.0] * 96, [8.0] * 8])
G1, G4, G8 = slice(0, 96), slice(96, 192), slice(192, 200)
STATE_NAMES = [n for n, _ in mc.STATE_SPEC]


def bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def _jax_side(gains):
    consts = mc.pack_consts(SR)
    ctrl = mc.make_controls(SR, len(gains), noise_level=np.asarray(gains))
    c, sc = mc._merged_consts(consts, ctrl)
    st0 = mc.unpack_state(jnp.asarray(mc.init_state(SR, len(gains))))
    return consts, ctrl, c, sc, st0


def _port_side(consts, ctrl):
    pconsts = convert.chain_consts_from_numpy(
        {k: np.asarray(v) for k, v in consts.arrays.items()}, consts.scalars)
    pc = pmc.chain_tensors(pconsts, torch.from_numpy(np.asarray(ctrl)))
    return pc, pmc.scalar_tensors(pconsts)


def _to_torch(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


# ───────────────────── one step against the JAX package ──────────────────

STEP_GAINS = np.array([0.0, 1.0, 8.0])


@pytest.fixture(scope="module")
def step_env():
    consts, ctrl, c, sc, st0 = _jax_side(STEP_GAINS)
    pre = jax.jit(lambda st, u, g: mc.preamp_step(c, sc, st, u, g,
                                                  noise=True))
    pc, psc = _port_side(consts, ctrl)
    return pre, pc, psc, st0


def test_controls_and_seeds_match(step_env):
    ref = mc.make_controls(SR, 3, noise_level=STEP_GAINS)
    got = pmc.make_controls(SR, 3, noise_level=STEP_GAINS)
    assert np.array_equal(np.asarray(ref), got.numpy())
    a, b = pmc._CTRL_OFF["noise"]
    assert got[a:b, :].flatten().tolist() == [0.0, 1.0, 8.0]
    assert np.array_equal(bits(mc.init_state(SR, 3)),
                          bits(pmc.init_state(SR, 3).numpy()))
    assert pmc.SCALAR_NAMES[-1] == "nz_u_sigma"
    assert pmc.chain_scalars(pmc.pack_consts(SR))["nz_u_sigma"] == \
        pytest.approx(mc.pack_consts(SR).scalars["nz_u_sigma"], rel=1e-12)


def test_lcg_words_bit_identical_and_draws_within_2_ulp(step_env):
    pre, pc, psc, st0 = step_env
    u = np.zeros((1, 3), np.float32)
    g = np.full((1, 3), G_LDR, np.float32)
    st, pst = dict(st0), _to_torch(st0)
    for step in range(8):
        st, _ = pre(st, jnp.asarray(u), jnp.asarray(g))
        pst, _ = pmc.preamp_step(pc, psc, pst, torch.from_numpy(u),
                                 torch.from_numpy(g), noise=True)
        assert np.array_equal(bits(st["nz_lcg"]),
                              bits(pst["nz_lcg"].numpy())), step
        w, pw = np.asarray(st["nz_w"]), pst["nz_w"].numpy()
        ulps = np.abs(bits(w).astype(np.int64) - bits(pw).astype(np.int64))
        assert ulps.max() <= 2, (step, ulps.max())
        assert not w[:, 0].any() and not pw[:, 0].any()   # gain 0
        assert np.abs(pw[:, 1]).max() > 0.1               # gain 1: O(1)
    assert not np.array_equal(bits(st["nz_lcg"]), bits(st0["nz_lcg"]))


def _perturbed(st):
    """Float rows scaled by (1 ± 2⁻²²), alternating; the LCG words kept."""
    out = {}
    for k, v in st.items():
        a = np.array(v)
        if k != "nz_lcg":
            sign = np.where(np.arange(a.size).reshape(a.shape) % 2 == 0,
                            1.0, -1.0)
            a = (a * (1.0 + 2.0 ** -22 * sign)).astype(np.float32)
        out[k] = jnp.asarray(a)
    return out


@pytest.mark.parametrize("which", ["fresh", "mid"])
def test_preamp_step_noise(step_env, which):
    pre, pc, psc, st0 = step_env
    u = np.full((1, 3), 0.05, np.float32)
    g = np.asarray(st0["gldr_cur"])     # as the noise-off step gate
    st = dict(st0)
    if which == "mid":
        for _ in range(32):
            st, _ = pre(st, jnp.asarray(u), jnp.asarray(g))

    def ref_of(s):
        out, y = pre(s, jnp.asarray(u), jnp.asarray(g))
        return dict(out, out=y)

    ref, pert = ref_of(st), ref_of(_perturbed(st))
    got, y = pmc.preamp_step(pc, psc, _to_torch(st), torch.from_numpy(u),
                             torch.from_numpy(g), noise=True)
    got = dict(got, out=y)
    assert np.array_equal(bits(ref["nz_lcg"]), bits(got["nz_lcg"].numpy()))
    for k in ref:
        if k == "nz_lcg":
            continue
        r = np.asarray(ref[k], np.float64)
        sens = np.abs(np.asarray(pert[k], np.float64) - r).max()
        err = np.abs(r - got[k].numpy().astype(np.float64)).max()
        assert err <= sens + 1e-6 * np.abs(r).max(), \
            f"preamp_step(noise)/{which}: {k} off by {err:.3e} (reference " \
            f"2-ulp sensitivity {sens:.3e})"


# ───────────────────── the level, on many streams ────────────────────────


@pytest.fixture(scope="module")
def noise_runs():
    """preamp_step alone at the 100 kOhm LDR point on silence, N_STEPS
    oversampled steps × len(GAINS) streams → (port, jax) stage outputs."""
    consts, ctrl, c, sc, st0 = _jax_side(GAINS)
    s = len(GAINS)
    g = jnp.full((1, s), G_LDR, jnp.float32)
    u = jnp.zeros((1, s), jnp.float32)

    def body(carry, _):
        st = dict(zip(STATE_NAMES, carry))
        st, out = mc.preamp_step(c, sc, st, u, g, noise=True)
        return tuple(st[n] for n in STATE_NAMES), out

    _, outs = jax.lax.scan(body, tuple(st0[n] for n in STATE_NAMES), None,
                           length=N_STEPS)
    ref = np.asarray(outs)[:, 0, :]

    pc, psc = _port_side(consts, ctrl)
    pst = _to_torch(st0)
    pu, pg = torch.zeros((1, s)), torch.full((1, s), G_LDR)
    got = np.empty((N_STEPS, s), np.float32)
    with torch.inference_mode():
        for i in range(N_STEPS):
            pst, o = pmc.preamp_step(pc, psc, pst, pu, pg, noise=True)
            got[i] = o[0].numpy()
    return got, ref


def _rms_per_stream(o):
    """RMS around each stream's own mean, after the settle."""
    o = o[N_SETTLE:].astype(np.float64)
    return float(np.sqrt(((o - o.mean(0)) ** 2).mean()))


def _rms_across_streams(o):
    """RMS deviation across streams at each step, after the settle."""
    o = o[N_SETTLE:].astype(np.float64)
    return float(np.sqrt(((o - o.mean(1, keepdims=True)) ** 2).mean()))


def test_noise_rms_in_the_ngspice_band(noise_runs):
    got, _ = noise_runs
    assert np.isfinite(got).all()
    rms = _rms_per_stream(got[:, G1])
    print(f"gain 1: {rms * 1e6:.2f} uV per stream, "
          f"{_rms_across_streams(got[:, G1]) * 1e6:.2f} uV across streams")
    assert ANCHOR_RMS * 0.60 < rms < ANCHOR_RMS * 1.40, rms


def test_noise_gain_scales(noise_runs):
    got, _ = noise_runs
    r1 = _rms_across_streams(got[:, G1])
    r4 = _rms_across_streams(got[:, G4])
    print(f"gain 4 over gain 1: {r4 / r1:.2f} across streams, "
          f"{_rms_per_stream(got[:, G4]) / _rms_per_stream(got[:, G1]):.2f} "
          "per stream")
    assert 3.0 < r4 / r1 < 5.3, (r1, r4)


def test_noise_statistics_match_jax(noise_runs):
    got, ref = noise_runs
    for name, cols in (("gain 1", G1), ("gain 4", G4), ("gain 8", G8)):
        for est in (_rms_per_stream, _rms_across_streams):
            a, b = est(got[:, cols]), est(ref[:, cols])
            assert abs(a / b - 1.0) < 0.05, (name, est.__name__, a, b)
    # the settled mean (the draws' own mean through the stamp) as well
    a, b = got[N_SETTLE:, G4].mean(), ref[N_SETTLE:, G4].mean()
    assert abs(a / b - 1.0) < 0.05, (a, b)


def test_noise_streams_decorrelated(noise_runs):
    got, _ = noise_runs
    d = np.diff(got[N_STEPS // 4:, G8].astype(np.float64), axis=0)
    cc = np.corrcoef(d.T)
    off = cc[~np.eye(cc.shape[0], dtype=bool)]
    assert np.abs(off).max() < 0.15, cc


# ───────────────────── through render and the fast path ──────────────────


def test_noise_gain_zero_bit_identical():
    ctrl = pmc.make_controls(SR, 2, noise_level=0.0)
    state = pmc.init_state(SR, 2)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        (0.01 * rng.normal(size=(64, 2))).astype(np.float32))
    before = (pmc.PLAIN_CALLS, pmc.KERNEL_LAUNCHES,
              pmc.NOISE_KERNEL_LAUNCHES)
    out_a, st_a = pmc.render(SR, ctrl, state, audio)
    out_b, st_b = pmc.render(SR, ctrl, state, audio, noise=True)
    assert (pmc.PLAIN_CALLS, pmc.KERNEL_LAUNCHES,
            pmc.NOISE_KERNEL_LAUNCHES) == (before[0] + 2,) + before[1:]
    assert np.array_equal(bits(out_a.numpy()), bits(out_b.numpy()))
    for name, (a, b) in pmc._OFFSETS.items():
        same = np.array_equal(bits(st_a[a:b].numpy()),
                              bits(st_b[a:b].numpy()))
        if name == "nz_lcg":
            assert not same                      # the LCG ran
            assert np.array_equal(bits(st_a[a:b].numpy()),
                                  bits(state[a:b].numpy()))  # K2: untouched
        elif name != "nz_w":
            assert same, name


def test_fast_path_noise_smoke():
    kw = dict(seconds=96 / SR, sample_rate=SR, t_tile=32, device="cpu")
    quiet = fast.render_chord([60.0], 0.0, **kw).numpy()
    noisy = fast.render_chord([60.0], 0.0, noise_level=30.0, **kw).numpy()
    assert quiet.shape == noisy.shape == (96,)
    assert np.isfinite(noisy).all()
    assert np.abs(noisy - quiet).max() > 0.0
    # 30x gain on a silent render: a noise floor, not a blow-up
    assert np.abs(noisy).max() < 0.1


def test_render_noise_against_render_cpu():
    t_len, n_twins = 256, 3
    tt = np.arange(t_len) / SR
    sig = (np.minimum(np.arange(t_len) / 100.0, 1.0) * 0.01
           * np.sin(2 * np.pi * 220 * tt)).astype(np.float32)
    n = 1 + n_twins
    rng = np.random.default_rng(7)
    audio = np.tile(sig[:, None], (1, n))
    state = np.tile(np.asarray(mc.init_state(SR, 1)), (1, n))
    n_float = mc._OFFSETS["nz_lcg"][0]
    for i in range(1, n):    # 1-ulp twins on the same LCG words
        for arr in (audio, state[:n_float]):
            sign = rng.choice([-1.0, 1.0], size=arr[:, i].shape)
            arr[:, i] = (arr[:, i] * (1.0 + 2.0 ** -23 * sign)
                         ).astype(np.float32)
    ctrl = mc.make_controls(SR, n, noise_level=30.0)
    y, st = mc.render_cpu(mc.pack_consts(SR), ctrl, state, audio,
                          noise=True)
    y = np.asarray(y)

    got, pst = pmc.render(SR, pmc.make_controls(SR, 1, noise_level=30.0),
                          torch.from_numpy(state[:, :1].copy()),
                          torch.from_numpy(audio[:, :1].copy()), noise=True)
    got = got.numpy()[:, 0]
    a, b = pmc._OFFSETS["nz_lcg"]
    assert np.array_equal(bits(np.asarray(st)[a:b, :1]),
                          bits(pst[a:b].numpy()))

    def db(err, ref):
        return 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30)
                               / np.sqrt(np.mean(ref ** 2)))

    quiet, _ = pmc.render(SR, pmc.make_controls(SR, 1),
                          torch.from_numpy(state[:, :1].copy()),
                          torch.from_numpy(audio[:, :1].copy()))
    sens = max(db(y[:, i] - y[:, 0], y[:, 0]) for i in range(1, n))
    out_db = db(got - y[:, 0], y[:, 0])
    noise_db = db(got - quiet.numpy()[:, 0], y[:, 0])
    print(f"render(noise=True) vs render_cpu: {out_db:.1f} dB (twins "
          f"{sens:.1f}); the noise itself {noise_db:.1f} dB")
    assert out_db < sens + 3.0, \
        f"{out_db:.1f} dB (reference sensitivity {sens:.1f} dB)"
    # the noise is in the output at all (the chain amplifies the rounding
    # of the noise too, so the twins sit at the noise's own level)
    assert noise_db > -60.0, noise_db
