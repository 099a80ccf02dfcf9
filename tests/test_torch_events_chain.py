"""The PyTorch port's event-scheduled serial path as a whole:
`fast.render_events` on the CPU against the JAX `fast.render_events`, tiny (44.1 kHz, t_tile=32,
a 32-sample warm-up and two carried blocks of 128 samples).

The JAX function runs with its own voice-bank kernel (interpret mode); its
chain calls are caught on their way in (the compiled block program is run
eagerly for that), and the chain itself runs once over everything those
calls were given (warm-up silence, then the blocks' audio) through the JAX
package's scan twin `render_cpu`, together with three twins whose input and
initial state are perturbed by one float32 ulp. The chain is a pure
recurrence and every call is even, so one call over the concatenation is
what the block-by-block calls compute.

Checks:
  * the composition, exactly: the port's chain calls get the port's
    controls, the initial state, a warm-up of exactly the rounded-up
    length of silence, and each block's state is the previous call's;
    each block's audio is the lane sum of the port's own carried voice-bank
    call; the output is the calls' outputs in order;
  * block-streamed equals unblocked, bit for bit: one voice-bank call and
    one chain call over the whole render give the same samples;
  * the audio entering the chain against the reference's, ≤ −80 dB
    relative RMS (packing, the events kernel, the lane sum);
  * the output against the reference's: no worse than the reference's own
    worst 1-ulp twin + 3 dB (the chain's free trajectory amplifies
    rounding; see test_torch_fast.py and ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openwurli_tpu import fast as jfast
from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu_torch import fast
from openwurli_tpu_torch.kernels import mono_chain as pmc
from openwurli_tpu_torch.kernels import voice_bank as pvb

torch.set_num_threads(1)

SR = 44100.0
T_TILE = 32
N_TWINS = 3
SUM_DB = -80.0
MIDIS = np.array([45.0, 60.0, 76.0])
VELS = np.array([0.9, 0.8, 0.7])
ONSETS = np.array([0.0, 32.0, 96.0])
RELEASES = np.array([100.0, 180.0, np.inf])
WARM, T_BLK, T_TOTAL = 32, 128, 250   # 250 is cut from two blocks of 128


def db(err, sig):
    return 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30)
                           / np.sqrt(np.mean(sig ** 2)))


def perturb(x, rng):
    """x scaled by (1 ± 2⁻²³) elementwise, random signs."""
    sign = rng.choice([-1.0, 1.0], size=x.shape)
    return (x * (1.0 + 2.0 ** -23 * sign)).astype(np.float32)


def jax_chain_calls(monkeypatch, render, *args, **kw):
    """Run a JAX fast renderer with its chain calls caught: → [(controls,
    state, audio)] as NumPy arrays, in call order. The stand-in returns
    silence and the state it was given."""
    calls = []

    def stand_in(base_sr, controls, state_flat, audio, interpret=False,
                 t_tile=None, noise=False):
        assert base_sr == SR and not noise
        calls.append((np.asarray(controls), np.asarray(state_flat),
                      np.asarray(audio)))
        return jnp.zeros_like(audio), state_flat

    with monkeypatch.context() as m:
        m.setattr(mc, "render_tpu", stand_in)
        m.setattr(jax, "jit", lambda f, **_kw: f)  # the block program, eager
        render(*args, **kw)
    return calls


def chain_with_twins(controls, state, audio):
    """render_cpu over audio (T, S) from state (rows, S), as stream block 0,
    plus N_TWINS blocks with input and float state rows perturbed by one
    ulp → (ref (T, S), [twin (T, S)] * N_TWINS)."""
    s = audio.shape[1]
    n = 1 + N_TWINS
    rng = np.random.default_rng(7)
    both = np.tile(audio, (1, n)).astype(np.float32)
    st = np.tile(state, (1, n)).astype(np.float32)
    n_float = mc._OFFSETS["nz_lcg"][0]
    for i in range(1, n):
        cols = slice(i * s, (i + 1) * s)
        both[:, cols] = perturb(both[:, cols], rng)
        st[:n_float, cols] = perturb(st[:n_float, cols], rng)
    y, _ = mc.render_cpu(mc.pack_consts(SR), np.tile(controls, (1, n)), st,
                         both)
    y = np.asarray(y)
    return y[:, :s], [y[:, i * s:(i + 1) * s] for i in range(1, n)]


def spy_on_port_chain(monkeypatch):
    """Catch the port's chain calls: → list filled with (controls, state,
    audio, (out, state')) per call."""
    calls = []
    render = pmc.render

    def spy(base_sr, controls, state, x, noise=False):
        result = render(base_sr, controls, state, x, noise=noise)
        calls.append((controls.clone(), state.clone(), x.clone(), result))
        return result

    monkeypatch.setattr(pmc, "render", spy)
    return calls


def bits(x):
    return x.contiguous().view(torch.int32)


def test_render_events_matches_jax_composition(monkeypatch):
    kw = dict(seconds=T_TOTAL / SR, sample_rate=SR, volume=0.5, depth=0.5,
              character=0.0, warm_seconds=WARM / SR,
              block_seconds=T_BLK / SR, t_tile=T_TILE)
    ref_calls = jax_chain_calls(monkeypatch, jfast.render_events, MIDIS,
                                VELS, ONSETS, RELEASES, interpret=True, **kw)
    assert [c[2].shape for c in ref_calls] == [(WARM, 1), (T_BLK, 1),
                                               (T_BLK, 1)]
    assert not ref_calls[0][2].any()
    ref_audio = np.concatenate([c[2] for c in ref_calls])
    ref, twins = chain_with_twins(ref_calls[0][0], ref_calls[0][1],
                                  ref_audio)
    ref = ref[WARM:WARM + T_TOTAL, 0]
    twins = [tw[WARM:WARM + T_TOTAL, 0] for tw in twins]

    calls = spy_on_port_chain(monkeypatch)
    before = (pvb.PLAIN_CALLS, pmc.PLAIN_CALLS, pvb.KERNEL_LAUNCHES,
              pmc.KERNEL_LAUNCHES)
    got = fast.render_events(MIDIS, VELS, ONSETS, RELEASES, device="cpu",
                             **kw)
    assert got.shape == (T_TOTAL,) and got.dtype == torch.float32
    assert pvb.PLAIN_CALLS == before[0] + 2
    assert pmc.PLAIN_CALLS == before[1] + 3
    assert (pvb.KERNEL_LAUNCHES, pmc.KERNEL_LAUNCHES) == before[2:]

    # the composition, bit for bit, from the port's own pieces
    assert len(calls) == 3
    ctrl = pmc.make_controls(SR, 1, volume=0.5, depth=0.5, character=0.0)
    assert all(torch.equal(c[0], ctrl) for c in calls)
    assert torch.equal(bits(calls[0][1]), bits(pmc.init_state(SR, 1)))
    assert calls[0][2].shape == (WARM, 1) and not calls[0][2].any()
    for prev, call in zip(calls, calls[1:]):
        assert torch.equal(bits(call[1]), bits(prev[3][1]))
    params, _ = pvb.make_kernel_params(MIDIS, VELS, SR, onsets=ONSETS,
                                       releases=RELEASES)
    assert pvb._has_events(params) and pvb._min_release(params) == 100.0
    vstate = pvb.init_bank_state(params)
    for b, call in enumerate(calls[1:]):
        voices, vstate = pvb.render_voice_bank(
            params, T_BLK, steady=pvb.steady_limits(params), state=vstate,
            n0=b * T_BLK, return_state=True, events=True, min_release=100.0)
        assert torch.equal(call[2], voices.sum(-1, keepdim=True))
    assert torch.equal(got, torch.cat([c[3][0][:, 0]
                                       for c in calls[1:]])[:T_TOTAL])

    # block-streamed equals unblocked, bit for bit
    voices = pvb.render_voice_bank(params, 2 * T_BLK,
                                   steady=pvb.steady_limits(params))
    audio = voices.sum(-1, keepdim=True)
    assert torch.equal(audio, torch.cat([c[2] for c in calls[1:]]))
    whole, _ = pmc.render_chain_plain(pmc.pack_consts(SR), ctrl,
                                      calls[0][3][1], audio)
    assert torch.equal(whole[:T_TOTAL, 0], got)

    # the chain's input and the output against the reference
    x = torch.cat([c[2] for c in calls]).numpy()
    sum_db = db(x - ref_audio, ref_audio)
    sens = max(db(tw - ref, ref) for tw in twins)
    out_db = db(got.numpy() - ref, ref)
    print(f"render_events: chain input {sum_db:.1f} dB, output "
          f"{out_db:.1f} dB (twins {sens:.1f})")
    assert sum_db <= SUM_DB, f"chain input {sum_db:.1f} dB"
    assert np.abs(got.numpy()).max() > 1e-4
    assert out_db < sens + 3.0, \
        f"{out_db:.1f} dB (reference sensitivity {sens:.1f} dB)"


def test_render_events_warm_up_rounds_up_and_tile_is_checked(monkeypatch):
    """33 samples of warm-up at t_tile=32 are two tiles (the serial path
    rounds int(warm·sr) UP); no warm-up, no warm-up call."""
    calls = []

    def fake(base_sr, controls, state, x, noise=False):
        calls.append(x.shape[0])
        return torch.zeros_like(x), state

    monkeypatch.setattr(pmc, "render", fake)
    kw = dict(seconds=64 / SR, sample_rate=SR, block_seconds=64 / SR,
              t_tile=T_TILE, device="cpu")
    fast.render_events(MIDIS, VELS, ONSETS, RELEASES,
                       warm_seconds=33.5 / SR, **kw)
    fast.render_events(MIDIS, VELS, ONSETS, RELEASES, warm_seconds=0.0, **kw)
    assert calls == [64, 64, 64]
    for t_tile in (24, -32):
        try:
            fast.render_events(MIDIS, VELS, ONSETS, RELEASES,
                               **{**kw, "t_tile": t_tile})
        except ValueError:
            continue
        raise AssertionError(f"t_tile={t_tile} accepted")
