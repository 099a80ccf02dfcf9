"""The PyTorch port's slice as a whole: `fast.render_grid` on the CPU
against the composition the JAX `fast.render_grid` runs — voice bank
(interpret mode, steady gating) → stream-major lane sum → `render_cpu` —
from a cold start (the warm-up case is `test_torch_fast_warm.py`), and the
tonal anchor of `test_quick_gates.py` through `render_chord`.

Checks:
  * the composition, exactly: render_grid's chain calls are caught on
    their way in. Each gets the port's controls and the initial state
    bit for bit (both held to the JAX packers in their own tests); a
    warm-up is exactly `warm` samples of silence whose end state is the
    state of the next call; the output is that call's output;
  * the chain's input — the per-stream voice sum — against the JAX voice
    bank plus the same sum, ≤ −80 dB relative RMS (packing, stream-major
    lane order, padding, steady gating);
  * cold start only, the head (the first HEAD samples): within 3 dB of
    the reference's own response to 1-ulp perturbations (below). The
    chain's start-up transient amplifies rounding from the second sample
    on (the reference's twins already move −52…−62 dB over the first 16
    samples), so no tighter head gate exists against an independent
    float32 implementation; after a warm-up the port's state already
    differs by the warm-up's own divergence;
  * the whole render: the port may differ from the reference by no more
    than the reference differs from itself when its initial chain state
    and its input are perturbed by one float32 ulp (random signs; the
    worst of three such twins), plus 3 dB. The chain's free trajectory
    amplifies ulp-level differences between XLA's compiled float32 and the
    port's eager float32, so the −80 dB target is missed over the whole
    render (levels in ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from openwurli_tpu.calib import goertzel
from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu.kernels import voice_bank as vb
from openwurli_tpu_torch import fast, tables
from openwurli_tpu_torch.kernels import mono_chain as pmc
from openwurli_tpu_torch.kernels import voice_bank as pvb
from test_quick_gates import TONAL_GOLDEN_DB, TONAL_TOL_DB

torch.set_num_threads(1)

SR = 44100.0
MIDIS = np.array([[40.0, 52.0, 64.0], [57.0, 69.0, 81.0]])
VEL = 0.8
T = 1024
N_TWINS = 3
HEAD = 16
SUM_DB = -80.0


def _db(err, sig):
    return 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30)
                           / np.sqrt(np.mean(sig ** 2)))


def _perturb(x, rng):
    """x scaled by (1 ± 2⁻²³) elementwise, random signs."""
    sign = rng.choice([-1.0, 1.0], size=x.shape)
    return (x * (1.0 + 2.0 ** -23 * sign)).astype(np.float32)


def reference_case(warm, t_len=T):
    """The JAX composition for `warm` samples of silent warm-up, in one
    render_cpu call: streams 0-1 are the reference, each further pair a
    twin whose input and initial chain state (float rows) are perturbed
    by one ulp. → (voice sum (t_len, 2), ref (t_len, 2),
    [twin (t_len, 2)] * N_TWINS)."""
    s, v = MIDIS.shape
    params, _ = vb.make_kernel_params(MIDIS.reshape(-1),
                                      np.full(s * v, VEL), SR, lanes=128)
    voices = np.asarray(vb.render_voice_bank(
        params, t_len, True, events=False,
        steady=vb.steady_limits(params)))[:, :s * v]
    audio = voices.reshape(t_len, s, v).sum(-1)
    n = 1 + N_TWINS
    rng = np.random.default_rng(7)
    both = np.zeros((warm + t_len, n * s), np.float32)
    state = np.array(mc.init_state(SR, n * s))
    n_float = mc._OFFSETS["nz_lcg"][0]  # rows below it are floats
    for i in range(n):
        cols = slice(i * s, (i + 1) * s)
        both[warm:, cols] = audio if i == 0 else _perturb(audio, rng)
        if i:
            state[:n_float, cols] = _perturb(state[:n_float, cols], rng)
    y, _ = mc.render_cpu(mc.pack_consts(SR),
                         mc.make_controls(SR, n * s, volume=0.5, depth=0.5,
                                          character=0.0),
                         state, both)
    y = np.asarray(y)[warm:]
    return audio, y[:, :s], [y[:, i * s:(i + 1) * s] for i in range(1, n)]


def check_render_grid(monkeypatch, warm, audio, ref, twins, t_tile=None):
    """render_grid on the CPU against the reference case; each chain call
    is caught with its inputs and result."""
    t_len = ref.shape[0]
    calls = []
    render = pmc.render

    def spy(base_sr, controls, state, x, noise=False):
        result = render(base_sr, controls, state, x, noise=noise)
        calls.append((base_sr, controls.clone(), state.clone(), x.clone(),
                      result))
        return result

    monkeypatch.setattr(pmc, "render", spy)
    before = (pvb.PLAIN_CALLS, pmc.PLAIN_CALLS, pvb.KERNEL_LAUNCHES,
              pmc.KERNEL_LAUNCHES)
    got = fast.render_grid(MIDIS, VEL, t_len / SR, warm_seconds=warm / SR,
                           t_tile=t_tile, device="cpu")
    assert got.shape == (t_len, 2) and got.dtype == torch.float32
    assert got.device.type == "cpu"

    # the composition, bit for bit
    assert len(calls) == (2 if warm else 1)
    ctrl = pmc.make_controls(SR, 2, volume=0.5, depth=0.5, character=0.0)
    for base_sr, controls, _, _, _ in calls:
        assert base_sr == SR and torch.equal(controls, ctrl)
    assert torch.equal(calls[0][2], pmc.init_state(SR, 2))
    if warm:
        silence = calls[0][3]
        assert silence.shape == (warm, 2) and not silence.any()
        assert torch.equal(calls[1][2], calls[0][4][1])
    x, (y, _) = calls[-1][3], calls[-1][4]
    tile = t_tile or pmc.T_TILE
    assert x.shape == (-(-t_len // tile) * tile, 2)
    assert torch.equal(got, y[:t_len])

    x = x.numpy()[:t_len]
    got = got.numpy()
    for s in range(2):
        sum_db = _db(x[:, s] - audio[:, s], audio[:, s])
        head_db = _db(got[:HEAD, s] - ref[:HEAD, s], ref[:HEAD, s])
        head_sens = max(_db(tw[:HEAD, s] - ref[:HEAD, s], ref[:HEAD, s])
                        for tw in twins)
        sens = max(_db(tw[:, s] - ref[:, s], ref[:, s]) for tw in twins)
        db = _db(got[:, s] - ref[:, s], ref[:, s])
        print(f"warm={warm} stream {s}: voice sum {sum_db:.1f} dB, head "
              f"{head_db:.1f} dB (twins {head_sens:.1f}), whole {db:.1f} dB "
              f"(twins {sens:.1f})")
        assert sum_db <= SUM_DB, f"stream {s}: voice sum {sum_db:.1f} dB"
        if not warm:
            assert head_db < head_sens + 3.0, f"stream {s}: head " \
                f"{head_db:.1f} dB (reference sensitivity {head_sens:.1f})"
        assert db < sens + 3.0, f"stream {s}: {db:.1f} dB (reference " \
            f"sensitivity {sens:.1f} dB)"
    # the CPU path went through the plain versions only
    assert pvb.PLAIN_CALLS == before[0] + 1
    assert pmc.PLAIN_CALLS == before[1] + (2 if warm else 1)
    assert (pvb.KERNEL_LAUNCHES, pmc.KERNEL_LAUNCHES) == before[2:]


def test_render_grid_matches_jax_composition_cold(monkeypatch):
    check_render_grid(monkeypatch, 0, *reference_case(0))


@pytest.mark.slow
def test_tonal_anchor():
    """H1-H6 of note 72 at v=120 against the reference's golden values
    (6144 samples, window 2048:6144)."""
    out = fast.render_chord([72.0], 120 / 127.0, 6144 / SR,
                            device="cpu").numpy()
    seg = out[2048:6144].astype(np.float64)
    f0 = float(tables.midi_to_freq(72.0))
    _f0r, amps = goertzel.harmonic_ladder(seg, f0, SR, n_harmonics=6)
    hs = 20 * np.log10(np.maximum(np.asarray(amps).ravel(), 1e-12))
    for h, (got, want, tol) in enumerate(
            zip(hs, TONAL_GOLDEN_DB, TONAL_TOL_DB), start=1):
        assert abs(got - want) < tol, (
            f"H{h} drifted: {got:.2f} dB vs golden {want:.2f} (tol {tol})")
