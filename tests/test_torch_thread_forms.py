"""E8 (`tremolo_scan_kernel`, a warp per circuit on `tremolo_step_warp`)
and E2's behavioral thread form (`engine_chain_kernel<PRE, PA_BEHAVIORAL>`,
a thread per engine with each step's values in registers and the engine's
rows in shared memory) of `csrc/engine.cu`, rehearsed on the CPU: the
source built once with g++ against the host shim of tests/cuda_host_shim.py,
with the kernels they replaced appended (the one-thread E8 on E2's
`tremolo_step`, and the thread form on `chain_sample` over a local copy of
the engine's 205 chain rows).

  (a) in one binary, E8 equals the one-thread E8 bit for bit, output and
      all E8_ROWS rows, at 1, 5 and 33 circuits × 64 steps at depths 0 /
      0.5 / 1 from seeded starts, with a kicked circuit (its BE replay)
      and a NaN circuit (the oscillator's reset) placed off the first
      circuit of the block;
  (b) E8 against `tremolo_scan_plain` within TOL (test_torch_settle_warp's);
  (c) each behavioral thread form equals the one-thread kernel bit for
      bit, output and all 205 chain rows, at B = 1 to 4 on
      test_torch_chain_half's clean, kicked and guard #2 engines, and at
      B = 33 (two blocks, the second partial);
  (d) the thread form against `chain_plain` within test_torch_chain_half's
      TOL_OUT and TOL_STATE.

Both sides of (a) and (c) use the host's libm, so any difference there
would be a fault of the new kernels: a row of the frame read or written at
the wrong place, a reset that misses a row, a lane that owns no row.
"""

import ctypes
import os

import cuda_host_shim
import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import engine as ek

torch.set_num_threads(1)

SR_TREM = 88200.0  # the stage bench's rate
N_TREM = 64
SR = 44100.0
N = 12
MODELS = [("dk", "behavioral"), ("melange", "behavioral")]
NOISE = {"dk": 0.0, "melange": 30.0}
NOISE_PLAIN = {"dk": 0.0, "melange": 3.0}
# test_torch_chain_half's engines; B = 33 cycles through the three kinds
BATCHES = {1: ("guard",), 2: ("clean", "kicked"),
           3: ("kicked", "clean", "guard"),
           4: ("guard", "clean", "clean", "kicked"),
           33: tuple(("clean", "kicked", "guard")[k % 3] for k in range(33))}
TOL = 1e-9
REL_TOL = 1e-12
TOL_OUT = 1e-11
TOL_STATE = 1e-9

# The kernels before this design: E8 on one thread per circuit, and E2's
# behavioral thread form over a local array of the engine's chain rows.
HARNESS = r"""
namespace {
void old_tremolo_scan_kernel(const double* c, double* state,
                             const double* depth, double* out, int n,
                             int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double ch[CHAIN_ROWS];
  for (int k = 0; k < E8_ROWS; ++k)
    ch[CH_TREM_V + k] = state[(size_t)k * g + j];
  const double* misc = c + C_MISC;
  const double d = depth[j];
  for (int t = 0; t < n; ++t)
    out[(size_t)t * g + j] = tremolo_step(c, misc, ch, d);
  for (int k = 0; k < E8_ROWS; ++k)
    state[(size_t)k * g + j] = ch[CH_TREM_V + k];
}

template <int PRE>
void old_chain_kernel(const double* c, const double* mono, double* chain,
                      float* out, int n, int b, const unsigned char* sag,
                      const double* noise_scale) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= b) return;
  double ch[CHAIN_ROWS];
  for (int k = 0; k < CHAIN_ROWS; ++k)
    ch[k] = chain[(size_t)e * CHAIN_ROWS + k];
  double last_char = __longlong_as_double(0x7ff8dead0000beefLL);
  Speaker spk_k;
  for (int t = 0; t < n; ++t) {
    const size_t i = (size_t)e * n + t;
    out[i] = (float)chain_sample<PRE, PA_BEHAVIORAL>(
        c, ch, mono[i], sag[e] != 0, noise_scale[e], &last_char, &spk_k);
  }
  for (int k = 0; k < CHAIN_ROWS; ++k)
    chain[(size_t)e * CHAIN_ROWS + k] = ch[k];
}
}  // namespace

extern "C" int ow_test_old_tremolo_scan(const double* consts, double* state,
                                        const double* depth, double* out,
                                        int n, int g) {
  shim::launch((g + 31) / 32, g < 32 ? g : 32, old_tremolo_scan_kernel,
               consts, state, depth, out, n, g);
  return 0;
}

extern "C" int ow_test_old_chain(int pre, const double* consts,
                                 const double* mono, double* chain,
                                 float* out, int n, int b,
                                 const unsigned char* sag,
                                 const double* noise_scale) {
  const int blocks = (b + 31) / 32, threads = b < 32 ? b : 32;
  if (pre == PRE_DK)
    shim::launch(blocks, threads, old_chain_kernel<PRE_DK>, consts, mono,
                 chain, out, n, b, sag, noise_scale);
  else
    shim::launch(blocks, threads, old_chain_kernel<PRE_MELANGE>, consts,
                 mono, chain, out, n, b, sag, noise_scale);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_host_shim.have_gxx():
        pytest.skip("needs g++ to build the kernel against the host shim")
    dll = cuda_host_shim.build(
        os.path.join(os.path.dirname(ek.__file__), "..", "csrc",
                     "engine.cu"),
        tmp_path_factory.mktemp("thread_forms"), "thread_forms",
        extra=HARNESS)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ow_tremolo_scan.argtypes = [p, i, p, p, p, i, i, p]
    dll.ow_test_old_tremolo_scan.argtypes = [p, p, p, p, i, i]
    dll.ow_engine_chain.argtypes = [p, i, p, p, p, i, i, p, i, i, p, i, p]
    dll.ow_test_old_chain.argtypes = [i, p, p, p, p, i, i, p, p]
    return dll


def _bits(x):
    return x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _close(a, b, tol):
    assert torch.equal(torch.isnan(b), torch.isnan(a))
    err = (a.double() - b.double()).nan_to_num().abs().max()
    assert err <= tol, err


# ── E8 ──

def _circuits(g, seed=29):
    """(state (TREM_ROWS, g), depth (g,)): the tremolo settled at SR_TREM,
    node voltages and LDR envelopes seeded, depths 0 / 0.5 / 1 in turn;
    circuit 2 (of g ≥ 3) kicked 70 V off (its BE replay), circuit g - 2
    (of g ≥ 5) with a NaN node (the oscillator's reset); g = 1 kicked."""
    rng = np.random.default_rng(seed)
    st = ek.init_tremolo_scan_state(SR_TREM, g)
    st[:ek.N_T] += torch.from_numpy(rng.uniform(-0.05, 0.05, (ek.N_T, g)))
    trem0 = ek.CHAIN_OFF["trem_v"][0]
    st[ek.CHAIN_OFF["trem_env"][0] - trem0] = torch.from_numpy(
        rng.uniform(0.0, 0.8, g))
    st[0, 2 if g >= 3 else 0] += 70.0
    if g >= 5:
        st[2, g - 2] = float("nan")
    depth = torch.tensor([(0.0, 0.5, 1.0)[j % 3] for j in range(g)],
                         dtype=torch.float64)
    return st.contiguous(), depth


def _e8(lib, st, depth, old=False):
    consts = torch.from_numpy(ek.scan_consts(SR_TREM, "tremolo"))
    g = st.shape[1]
    out = torch.empty((N_TREM, g), dtype=torch.float64)
    if old:
        err = lib.ow_test_old_tremolo_scan(consts.data_ptr(), st.data_ptr(),
                                           depth.data_ptr(), out.data_ptr(),
                                           N_TREM, g)
    else:
        err = lib.ow_tremolo_scan(consts.data_ptr(), consts.numel(),
                                  st.data_ptr(), depth.data_ptr(),
                                  out.data_ptr(), N_TREM, g, None)
    assert err == 0
    return out


@pytest.mark.parametrize("g", [1, 5, 33])
def test_e8_warp_equals_one_thread(lib, g):
    st0, depth = _circuits(g)
    st_w, st_t = st0.clone(), st0.clone()
    out_w = _e8(lib, st_w, depth)
    out_t = _e8(lib, st_t, depth, old=True)
    assert _same(out_w, out_t)
    assert _same(st_w, st_t)
    assert torch.isfinite(out_w).all() and torch.isfinite(st_w).all()
    diag = ek.CHAIN_OFF["trem_diag"][0] - ek.CHAIN_OFF["trem_v"][0]
    kicked = 2 if g >= 3 else 0
    assert st_w[diag + 4, kicked] > 0, "the kick reached the BE replay"
    if g >= 5:
        assert st_w[diag + 2, g - 2] == 1, "the NaN node reset once"
        assert (st_w[diag + 2, :g - 2] == 0).all()
        assert st_w[diag + 4, 1] == 0


@pytest.mark.parametrize("g", [5])
def test_e8_matches_plain(lib, g):
    """The voltages, the envelope and the counters within TOL; the shunt
    and the LDR resistance, in ohms (10^3-10^6), within REL_TOL of their
    size (measured here: 3.0e-13 V, 4.5e-16 and 4.9e-15 relative)."""
    st0, depth = _circuits(g)
    st_w, st_p = st0.clone(), st0.clone()
    out_w = _e8(lib, st_w, depth)
    out_p = ek.tremolo_scan_plain(SR_TREM, st_p, depth, N_TREM)
    _close(out_w / out_p, torch.ones_like(out_p), REL_TOL)
    _close(st_w[:-1], st_p[:-1], TOL)
    _close(st_w[-1] / st_p[-1], torch.ones_like(st_p[-1]), REL_TOL)


# ── E2's behavioral thread form ──

def _engine(cp, kind, ramps=True):
    """test_torch_chain_half's engines: "clean" a 440 Hz sine from rest;
    "kicked" the tremolo 70 V off and a 30 V spike at sample 5; "guard" a
    NaN in mono at sample 3 and the volume smoother reaching a NaN target
    at sample 6 (guard #2 from there); the depth ramping on "clean", the
    character on "kicked"."""
    state = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    t = np.arange(N)
    mono = torch.from_numpy(0.3 * np.sin(2 * np.pi * 440 * t / SR))
    # every smoother row in use: the depth ramping on "clean", the
    # character (and so the speaker's redesign) on "kicked"
    name = {"clean": "sm_depth", "kicked": "sm_char"}.get(kind)
    if name and ramps:
        a, _ = ek.CHAIN_OFF[name]
        state[a + 1:a + 4] = torch.tensor([0.2, -0.05, 10.0],
                                          dtype=torch.float64)
    if kind == "kicked":
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0
        mono[5] = 30.0
    elif kind == "guard":
        mono[3] = float("nan")
        a, _ = ek.CHAIN_OFF["sm_volume"]
        state[a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 6.0],
                                          dtype=torch.float64)
    return state, mono


def _batch(cp, kinds, noise, ramps=True):
    rows = [_engine(cp, k, ramps) for k in kinds]
    b = len(kinds)
    state = torch.stack([r[0] for r in rows]).contiguous()
    # the power amp's rows off rest, so that guard #2's reset shows
    lo, hi = ek.CHAIN_OFF["pa_v"][0], ek.CHAIN_OFF["pa_last"][1]
    state[:, lo:hi] += 1.0
    return (state, torch.stack([r[1] for r in rows]).contiguous(),
            torch.tensor([k != 1 for k in range(b)]),
            torch.full((b,), noise[cp.preamp_model], dtype=torch.float64))


def _chain(lib, cp, state, mono, sag, scale, old=False):
    b, n = mono.shape
    consts = torch.from_numpy(cp.flat)
    st = state.clone()
    out = torch.empty((b, n), dtype=torch.float32)
    pre = ek.PREAMP_MODELS.index(cp.preamp_model)
    if old:
        err = lib.ow_test_old_chain(pre, consts.data_ptr(), mono.data_ptr(),
                                    st.data_ptr(), out.data_ptr(), n, b,
                                    sag.data_ptr(), scale.data_ptr())
    else:
        err = lib.ow_engine_chain(consts.data_ptr(), consts.numel(),
                                  mono.data_ptr(), st.data_ptr(),
                                  out.data_ptr(), n, b, sag.data_ptr(), pre,
                                  ek.PA_MODELS.index(cp.pa_model),
                                  scale.data_ptr(),
                                  ek.CHAIN_FORMS.index("thread"), None)
    assert err == 0
    return out, st


@pytest.mark.parametrize("b", sorted(BATCHES))
@pytest.mark.parametrize("models", MODELS, ids="-".join)
def test_thread_form_equals_one_thread_kernel(lib, models, b):
    cp = ek.chain_params(SR, *models)
    kinds = BATCHES[b]
    state, mono, sag, scale = _batch(cp, kinds, NOISE)
    out_n, st_n = _chain(lib, cp, state, mono, sag, scale)
    out_o, st_o = _chain(lib, cp, state, mono, sag, scale, old=True)
    assert _same(out_n, out_o)
    assert _same(st_n, st_o)
    assert torch.isfinite(out_n).all()
    lo, hi = ek.CHAIN_OFF["pa_v"][0], ek.CHAIN_OFF["pa_last"][1]
    trem = ek.CHAIN_OFF["trem_diag"][0]
    for e, kind in enumerate(kinds):
        if kind == "guard":
            assert (out_n[e, 6:] == 0).all() and (out_n[e, 1:3] != 0).all()
            assert not torch.equal(st_n[e, lo:hi], state[e, lo:hi])
        else:
            assert (out_n[e] != 0).any()
            assert torch.equal(st_n[e, lo:hi], state[e, lo:hi])
        if kind == "kicked":
            assert st_n[e, trem + 4] > 0, "the kick reached the BE replay"


@pytest.mark.parametrize("models", MODELS, ids="-".join)
def test_thread_form_matches_plain(lib, models):
    """test_torch_chain_half's plain case: two clean engines (one with
    rail sag off) and one at guard #2, no ramps (with the depth ramping,
    the host's libm takes the melange engine's f32 Newton on another path
    than torch's: a node row 3.1e-4 V off, the output the same; (c) holds
    the ramps bit for bit)."""
    cp = ek.chain_params(SR, *models)
    state, mono, sag, scale = _batch(cp, ("clean", "clean", "guard"),
                                     NOISE_PLAIN, ramps=False)
    out_n, st_n = _chain(lib, cp, state, mono, sag, scale)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, sag, scale)
    _close(out_n, out_p, TOL_OUT)
    _close(st_n, st_p, TOL_STATE)
