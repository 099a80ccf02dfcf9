"""Host packers of the PyTorch port against the JAX packers.

Same inputs through both; float arrays must agree within 2 float32 ulp,
integer rows (stored as float32 bit patterns) bit for bit, float scalars
to 1e-9 relative. Two exceptions: the two "corr0" columns hold the
residual of each package's own float64 DC operating-point solve (order
1e-13 V, solver rounding noise; see `_chain_tolerance`), and values below
1e-30 — modes the hammer dwell filter leaves 600 dB down, where the two
float64 `exp` implementations differ by ~1e-6 relative — are compared at
1e-36 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import mlp as ref_mlp
from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu.kernels import voice_bank as vb
from openwurli_tpu_torch import convert
from openwurli_tpu_torch import mlp as pmlp
from openwurli_tpu_torch.kernels import mono_chain as pmc
from openwurli_tpu_torch.kernels import voice_bank as pvb

torch.set_num_threads(1)

NOTES = np.repeat(np.arange(21, 109), 4).astype(np.float64)
VELS = np.tile([0.0, 0.05, 0.5, 1.0], 88)


def ulp_distance(a, b):
    """Elementwise |a − b| in float32 ulp of the larger magnitude."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    d = np.abs(a.astype(np.float64) - b)
    tiny = np.where(d > 1e-36, np.inf, 0.0)
    return np.where(mag < 1e-30, tiny, d / np.spacing(mag))


@pytest.fixture(scope="module", params=[(128, False), (128, True),
                                        (384, False), (384, True)],
                ids=lambda p: f"lanes{p[0]}-mlp{p[1]}")
def voice_params(request):
    lanes, mlp = request.param
    n = min(lanes, len(NOTES))
    ref, n_ref = vb.make_kernel_params(NOTES[:n], VELS[:n], 44100.0,
                                       mlp_enabled=mlp, lanes=lanes)
    got, n_got = pvb.make_kernel_params(NOTES[:n], VELS[:n], 44100.0,
                                        mlp_enabled=mlp, lanes=lanes)
    assert n_ref == n_got == n
    return np.asarray(ref), got.numpy()


def test_voice_params_float_rows(voice_params):
    ref, got = voice_params
    assert ref.shape == got.shape
    for row in range(pvb.N_ROWS):
        if row == pvb.ROW_RNG0:
            continue
        r, g = ref[row], got[row]
        if row == pvb.ROW_EVT:
            r = np.delete(r, pvb.EVT_ONSET_I, axis=0)
            g = np.delete(g, pvb.EVT_ONSET_I, axis=0)
        worst = ulp_distance(r, g).max()
        assert worst <= 2.0, f"row {row}: {worst} ulp"


def test_voice_params_int_rows_bit_identical(voice_params):
    ref, got = voice_params
    assert np.array_equal(ref[pvb.ROW_RNG0].view(np.uint32),
                          got[pvb.ROW_RNG0].view(np.uint32))
    assert np.array_equal(ref[pvb.ROW_EVT, pvb.EVT_ONSET_I].view(np.int32),
                          got[pvb.ROW_EVT, pvb.EVT_ONSET_I].view(np.int32))


def test_steady_limits_and_bank_state(voice_params):
    ref, got = voice_params
    assert vb.steady_limits(ref) == pvb.steady_limits(torch.from_numpy(got))
    st_ref = vb.init_bank_state(ref)
    st_got = pvb.init_bank_state(torch.from_numpy(got)).numpy()
    assert ulp_distance(st_ref[:40], st_got[:40]).max() <= 2.0
    assert np.array_equal(st_ref[40:].view(np.uint32),
                          st_got[40:].view(np.uint32))


@pytest.mark.parametrize("enabled", [False, True])
def test_mlp_weights_and_infer(enabled):
    ref_w = ref_mlp.load_weights()
    got_w = convert.mlp_weights_from_npz()
    for name in ref_w._fields:
        assert np.array_equal(np.asarray(getattr(ref_w, name)),
                              getattr(got_w, name)), name
    ref = ref_mlp.infer(jnp.asarray(NOTES), jnp.asarray(VELS),
                        enabled=enabled)
    got = pmlp.infer(NOTES, VELS, got_w, enabled=enabled)
    for name in ref._fields:
        assert np.allclose(np.asarray(getattr(ref, name)),
                           getattr(got, name), rtol=1e-12, atol=1e-12), name


@pytest.fixture(scope="module", params=[44100.0, 48000.0])
def chain_consts(request):
    return mc.pack_consts(request.param), pmc.pack_consts(request.param)


def _chain_tolerance(name):
    """Columns that hold DC-solve residuals get an absolute 1e-12 V
    tolerance; everything else the 2-ulp gate."""
    return {"pa_nvcols": 3, "trem_cols": 0}.get(name)


def test_pack_consts_arrays(chain_consts):
    ref, got = chain_consts
    for name in pmc.ARRAY_NAMES:
        r = np.asarray(ref.arrays[name])
        g = got.arrays[name]
        assert r.shape == g.shape, name
        col = _chain_tolerance(name)
        if col is not None:
            assert np.abs(r[:, col].astype(np.float64) - g[:, col]).max() \
                < 1e-12, name
            r = np.delete(r, col, axis=1)
            g = np.delete(g, col, axis=1)
        worst = ulp_distance(r, g).max()
        assert worst <= 2.0, f"{name}: {worst} ulp"


def test_pack_consts_scalars(chain_consts):
    ref, got = chain_consts
    assert set(ref.scalars) == set(got.scalars)
    for k, v in ref.scalars.items():
        w = got.scalars[k]
        if isinstance(v, tuple):
            assert np.allclose(v, w, rtol=1e-12, atol=0), k
        elif isinstance(v, int):
            assert v == w, k
        else:
            assert abs(v - w) <= 1e-9 * abs(v), (k, v, w)


@pytest.mark.parametrize("sr", [44100.0, 48000.0])
def test_init_state(sr):
    ref = mc.init_state(sr, 5)
    got = pmc.init_state(sr, 5).numpy()
    a, b = pmc._OFFSETS["nz_lcg"]
    assert np.array_equal(ref[a:b].view(np.uint32), got[a:b].view(np.uint32))
    assert ulp_distance(ref[:a], got[:a]).max() <= 2.0


@pytest.mark.parametrize("sr", [44100.0, 48000.0])
def test_make_controls_sweeps(sr):
    vol = np.array([0.0, 0.25, 0.5, 1.0, 0.7])
    depth = np.array([0.0, 0.3, 0.5, 1.0, 0.9])
    char = np.array([0.0, 0.0005, 0.5, 1.0, 0.2])
    for kw in (dict(volume=vol, depth=depth, character=char),
               dict(volume=0.5, depth=0.5, character=0.0),
               dict(volume=1.0, depth=1.0, character=1.0, rail_sag=False)):
        ref = mc.make_controls(sr, 5, **kw)
        got = pmc.make_controls(sr, 5, **kw).numpy()
        assert ulp_distance(ref, got).max() <= 2.0, kw
