"""E2's half form of `csrc/engine.cu` (`engine_chain_half_kernel<PRE, PA>`:
two engines to a warp, each on a 16-lane segment) rehearsed on the CPU:
the source built with g++ against the host shim of tests/cuda_host_shim.py
(a fiber per CUDA thread, a barrier per warp for __shfl_sync with width 8
and 16, __ballot_sync, __any_sync, __all_sync and __syncwarp).

For every instantiation <dk | melange, circuit | behavioral>, over a
chunk of a 440 Hz sine from each engine's initial state:

  (a) in one binary, the half form equals the thread form (a thread per
      engine, the one-thread steps) bit for bit, output and every chain
      row, at B = 1 to 4 (B = 1 and 3 leave the last warp's second
      segment without an engine), on engines whose two segments diverge:
      one engine runs clean while the other is kicked (the tremolo 70 V
      off, so its BE replay, and a 30 V input spike that fails the power
      amp's Newton) or reaches guard #2 midway (a NaN in mono, then a NaN
      volume target), each in the first and in the second segment;
  (b) the half form against `chain_plain`: the outputs within TOL_OUT and
      the chain rows within TOL_STATE (test_torch_pa_warp.py's
      tolerances: the host's libm against torch's, carried through
      Newton's 1e-9 V stop) where neither the kick nor a reset from far
      off equilibrium reaches the rows, NaN where the plain version is NaN.

Both sides of (a) use the host's libm, so any difference there would be a
fault of the segments' lane logic: a vote that reads the other engine's
lanes, a loop that leaves before both engines are done, a finished
engine's values not frozen, a pass that one engine needs leaking into the
other.
"""

import ctypes
import os

import cuda_host_shim
import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import engine as ek

torch.set_num_threads(1)

SR = 44100.0
N = 12
MODELS = [("dk", "circuit"), ("melange", "circuit"), ("dk", "behavioral"),
          ("melange", "behavioral")]
# the melange preamp's noise scale: 30 for (a); 3 against the plain
# version, where 30 leaves a Newton from the initial state unconverged and
# the host's libm then moves the melange rows by some 0.1 V from torch's
NOISE = {"dk": 0.0, "melange": 30.0}
NOISE_PLAIN = {"dk": 0.0, "melange": 3.0}
# engines by batch: each segment kicked or at guard #2 beside a clean one,
# in either segment; B = 1 and 3 leave a segment without an engine
BATCHES = {1: ("guard",), 2: ("clean", "kicked"),
           3: ("kicked", "clean", "guard"), 4: ("guard", "clean", "clean",
                                                "kicked")}
TOL_OUT = 1e-11
TOL_STATE = 1e-9


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_host_shim.have_gxx():
        pytest.skip("needs g++ to build the kernel against the host shim")
    dll = cuda_host_shim.build(
        os.path.join(os.path.dirname(ek.__file__), "..", "csrc",
                     "engine.cu"),
        tmp_path_factory.mktemp("chain_half"), "chain_half")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ow_engine_chain.argtypes = [p, i, p, p, p, i, i, p, i, i, p, i, p]
    return dll


def _bits(x):
    return x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _engine(cp, kind):
    """One engine's chain rows and mono: "clean" a 440 Hz sine from rest;
    "kicked" the tremolo 70 V off (BE replays) and a 30 V spike at sample
    5 (the power amp's Newton fails); "guard" a NaN in mono at sample 3
    (the preamp resets) and the volume smoother reaching a NaN target at
    sample 6 (guard #2 on every sample from there)."""
    state = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    t = np.arange(N)
    mono = torch.from_numpy(0.3 * np.sin(2 * np.pi * 440 * t / SR))
    if kind == "kicked":
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0
        mono[5] = 30.0
    elif kind == "guard":
        mono[3] = float("nan")
        a, _ = ek.CHAIN_OFF["sm_volume"]
        state[a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 6.0],
                                          dtype=torch.float64)
    return state, mono


def _batch(cp, kinds, noise=NOISE):
    rows = [_engine(cp, k) for k in kinds]
    b = len(kinds)
    return (torch.stack([r[0] for r in rows]).contiguous(),
            torch.stack([r[1] for r in rows]).contiguous(),
            torch.tensor([k != 1 for k in range(b)]),   # engine 1: no sag
            torch.full((b,), noise[cp.preamp_model], dtype=torch.float64))


def _run(lib, cp, state, mono, sag, scale, form):
    """ow_engine_chain in `form` (ek.CHAIN_FORMS) → (out, state)."""
    b, n = mono.shape
    consts = torch.from_numpy(cp.flat)
    st = state.clone()
    out = torch.empty((b, n), dtype=torch.float32)
    assert lib.ow_engine_chain(consts.data_ptr(), consts.numel(),
                               mono.data_ptr(), st.data_ptr(),
                               out.data_ptr(), n, b, sag.data_ptr(),
                               ek.PREAMP_MODELS.index(cp.preamp_model),
                               ek.PA_MODELS.index(cp.pa_model),
                               scale.data_ptr(),
                               ek.CHAIN_FORMS.index(form), None) == 0
    return out, st


def _close(a, b, tol):
    nan = torch.isnan(b)
    assert torch.equal(nan, torch.isnan(a))
    err = (a.double() - b.double()).nan_to_num().abs().max()
    assert err <= tol, err


@pytest.mark.parametrize("b", sorted(BATCHES))
@pytest.mark.parametrize("models", MODELS, ids="-".join)
def test_half_form_equals_thread_form(lib, models, b):
    cp = ek.chain_params(SR, *models)
    kinds = BATCHES[b]
    state, mono, sag, scale = _batch(cp, kinds)
    out_h, st_h = _run(lib, cp, state, mono, sag, scale, "half")
    out_t, st_t = _run(lib, cp, state, mono, sag, scale, "thread")
    assert _same(out_h, out_t)
    assert _same(st_h, st_t)
    assert torch.isfinite(out_h).all()
    for e, kind in enumerate(kinds):
        if kind == "guard":
            assert (out_h[e, 6:] == 0).all() and (out_h[e, 1:3] != 0).all()
        else:
            assert (out_h[e] != 0).any()
    if "kicked" in kinds and models[1] == "circuit":
        e = kinds.index("kicked")
        trem = ek.CHAIN_OFF["trem_diag"][0]
        pa = ek.CHAIN_OFF["pa_diag"][0]
        assert st_h[e, trem + 4] > 0, "the kick reached the BE replay"
        assert st_h[e, pa + 1] > 0, "the spike failed the power amp's Newton"
        assert st_h[kinds.index("clean"), trem + 4] == 0


@pytest.mark.parametrize("models", MODELS, ids="-".join)
def test_half_form_matches_plain(lib, models):
    """Two clean engines (one with rail sag off) and one at guard #2: the
    kick moves the unconverged Newton of the host's libm away from
    torch's (tests/test_torch_pa_warp.py), so (a) holds it alone, and the
    melange preamp's noise runs at NOISE_PLAIN."""
    cp = ek.chain_params(SR, *models)
    state, mono, sag, scale = _batch(cp, ("clean", "clean", "guard"),
                                     NOISE_PLAIN)
    out_h, st_h = _run(lib, cp, state, mono, sag, scale, "half")
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, sag, scale)
    _close(out_h, out_p, TOL_OUT)
    _close(st_h, st_p, TOL_STATE)


@pytest.mark.parametrize("models", MODELS, ids="-".join)
def test_chain_form_bands(models, monkeypatch):
    """chain_form gives the warp form up to CHAIN_WARP_MAX_ENGINES, the
    half form above it up to CHAIN_HALF_MAX_ENGINES and the thread form
    above both; None lifts a band's limit and 0 empties it."""
    warp = ek.CHAIN_WARP_MAX_ENGINES[models]
    half = ek.CHAIN_HALF_MAX_ENGINES[models]
    for b in (1, 2, 3, 96, 512, 513, 2048, 2049, 8192, 8193, 16384, 32768):
        want = ("warp" if warp is None or b <= warp
                else "half" if half is None or b <= half else "thread")
        assert ek.chain_form(*models, b) == want
    monkeypatch.setitem(ek.CHAIN_WARP_MAX_ENGINES, models, 0)
    monkeypatch.setitem(ek.CHAIN_HALF_MAX_ENGINES, models, 0)
    assert {ek.chain_form(*models, b) for b in (1, 4096)} == {"thread"}
    monkeypatch.setitem(ek.CHAIN_HALF_MAX_ENGINES, models, None)
    assert {ek.chain_form(*models, b) for b in (1, 1 << 20)} == {"half"}
    monkeypatch.setitem(ek.CHAIN_WARP_MAX_ENGINES, models, 3)
    assert [ek.chain_form(*models, b) for b in (3, 4)] == ["warp", "half"]
