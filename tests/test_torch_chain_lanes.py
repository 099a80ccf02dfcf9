"""Properties of the plain chain that the warp-per-stream CUDA kernel (K2 and
K5, `csrc/mono_chain.cu`) relies on, checked on the plain torch version.

  (a) the tremolo-owned rows never depend on the audio or on the NaN guard,
      so every lane of a warp can run the tremolo on its own;
  (b) a stream whose NaN guard fires (or whose power amp resets) leaves the
      other streams bit-identical to their run without it;
  (c) `_ge_solve_flat` updates every row of the remaining columns, those at
      and above the pivot with a zero multiplier, so a non-finite entry in
      a pivot row gives the NaNs of that full-height update (0 · inf) in
      the rows above it: the kernel's elimination computes those elements
      too.

Small sizes (S ≤ 4, 64 samples): seconds on one core.
"""

import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import mono_chain as mc

SR = 44100.0
S, T = 4, 64


def _bits(x):
    return x.contiguous().view(torch.int32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(
        (0.05 * rng.standard_normal((T, S))).astype(np.float32))
    ctrl = mc.make_controls(SR, S, volume=0.5, depth=np.linspace(0.2, 1, S),
                            character=np.array([0.0, 1.0, 0.0, 1.0]))
    return ctrl, mc.init_state(SR, S), audio


def _guard_case(state, audio, stream):
    """A NaN in the stream's speaker state: its first output is NaN, so the
    NaN guard fires once. An inf in its audio later: the up-sampler and
    preamp go non-finite and the power amp's reset path holds the output."""
    st, a = state.clone(), audio.clone()
    st[mc._OFFSETS["spk_lpf"][0], stream] = float("nan")
    a[T // 2, stream] = float("inf")
    return st, a


def test_tremolo_rows_ignore_audio_and_guard():
    ctrl, st0, audio = _inputs(1)
    consts = mc.pack_consts(SR)
    other = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (T, S)).astype(np.float32))
    st_g, a_g = _guard_case(st0, other, 1)
    out1, st1 = mc.render_chain_plain(consts, ctrl, st0, audio)
    out2, st2 = mc.render_chain_plain(consts, ctrl, st_g, a_g)
    g = mc._OFFSETS["guard_fires"][0]
    assert st1[g].tolist() == [0.0] * S
    assert st2[g, 1].item() == 1.0
    assert not torch.equal(out1, out2)
    for name, a, b, _ca, _cb in mc.preroll_rows():
        assert name in mc.TREM_STATE
        assert torch.equal(_bits(st1[a:b]), _bits(st2[a:b])), name
        assert not torch.equal(_bits(st1[a:b]), _bits(st0[a:b])) \
            or name == "trem_phase", name


def test_guard_stream_leaves_neighbours_bit_identical():
    ctrl, st0, audio = _inputs(3)
    consts = mc.pack_consts(SR)
    st_g, a_g = _guard_case(st0, audio, 2)
    ref, ref_st = mc.render_chain_plain(consts, ctrl, st0, audio)
    out, st = mc.render_chain_plain(consts, ctrl, st_g, a_g)
    g = mc._OFFSETS["guard_fires"][0]
    assert st[g].tolist() == [0.0, 0.0, 1.0, 0.0]
    assert out[0, 2].item() == 0.0 and torch.isfinite(out).all()
    # the power amp reset on every sample after the inf: its history is 0
    za, zb = mc._OFFSETS["pa_z"]
    assert st[za:zb, 2].abs().max().item() == 0.0
    assert ref_st[za:zb, 2].abs().max().item() > 0.0
    keep = [0, 1, 3]
    assert torch.equal(_bits(out[:, keep]), _bits(ref[:, keep]))
    assert torch.equal(_bits(st[:, keep]), _bits(ref_st[:, keep]))


def _ge_twin(cols, rhs, full_height=True):
    """The kernel's elimination (csrc/mono_chain.cu) for one stream in
    float32 NumPy: blk[j] column j, blk[m] the rhs. With full_height=False,
    rows at and above the pivot are skipped instead of updated with a zero
    multiplier: the shortcut a lane-parallel design must not take."""
    m = rhs.shape[0]
    blk = [np.array(cols[j], np.float32) for j in range(m)]
    blk.append(np.array(rhs, np.float32))
    invs = []
    with np.errstate(all="ignore"):
        for k in range(m):
            piv = blk[k][k]
            inv = np.float32(1.0) / (piv if abs(piv) > np.float32(1e-30)
                                     else np.float32(1e-30))
            invs.append(inv)
            below = np.array([(blk[k][i] if i > k else np.float32(0.0))
                              * inv for i in range(m)], np.float32)
            for j in range(k + 1, m + 1):
                rk = blk[j][k]
                for i in range(m):
                    if full_height or i > k:
                        blk[j][i] = blk[j][i] - below[i] * rk
        x = np.zeros(m, np.float32)
        for k in range(m - 1, -1, -1):
            xk = blk[m][k] * invs[k]
            x[k] = xk
            if k:
                for i in range(m):
                    if full_height or i < k:
                        blk[m][i] = blk[m][i] - (
                            blk[k][i] if i < k else np.float32(0.0)) * xk
    return x


def _ge_case(name):
    rng = np.random.default_rng(7)
    m = 4
    a = (np.eye(m) + 0.2 * rng.standard_normal((m, m))).astype(np.float32)
    rhs = rng.standard_normal(m).astype(np.float32)
    if name == "rhs_inf_last_row":
        rhs[m - 1] = np.inf
    elif name == "inf_in_pivot_row":
        a[2, 3] = np.inf          # row 2 of column 3, above its own pivot
    return a, rhs


@pytest.mark.parametrize("name", ["finite", "rhs_inf_last_row",
                                  "inf_in_pivot_row"])
def test_ge_solve_flat_full_height_nans(name):
    a, rhs = _ge_case(name)
    cols = torch.from_numpy(np.ascontiguousarray(a.T))[:, :, None]
    got = mc._ge_solve_flat(cols, torch.from_numpy(rhs)[:, None],
                            a.shape[0])[:, 0].numpy()
    want = _ge_twin(a.T, rhs)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got.view(np.int32)[~np.isnan(want)],
                          want.view(np.int32)[~np.isnan(want)])
    skip = _ge_twin(a.T, rhs, full_height=False)
    if name == "finite":
        assert np.isfinite(got).all()
        assert np.array_equal(got.view(np.int32), skip.view(np.int32))
    elif name == "rhs_inf_last_row":
        # the last step's zero-multiplier updates (0 · inf) make x[-1] NaN,
        # where skipping the rows at and above the pivot leaves it inf
        assert np.isnan(got[-1]) and np.isinf(skip[-1])
