"""`tools/torch_train_onset_model.py` against the JAX package's
`tools/train_onset_model.py` (both loaded from their files), on the CPU at
tiny sizes.

  * `add_synthetic_tones`, `synth_mixtures` (same seed) and `label_clip`:
    bit for bit (NumPy in both; the features are the ones
    `tests/test_torch_onset_model.py` holds equal).
  * `render_note_pool` at 44.1 kHz (a rate whose tremolo state is package
    data), 10 ms, depth 0, every 12th note at velocity 0.7: the reference
    runs its voice bank in interpret mode and its chain through
    `render_cpu` (a stand-in for `render_tpu`), together with three twins
    whose voice sum and initial chain state are moved by one float32 ulp.
    The port's chain input (the voice sum) within −80 dB of the
    reference's; each chain entry within the reference's own twin spread
    + 3 dB, over the first 16 samples and over the whole entry, the gate
    `tests/test_torch_fast.py` gives `render_grid`; the DI entries (voice
    bank only, peak-normalised) within −80 dB.
  * `main` on a cached pool (`--pool-npz`, `--clips 8 --steps 20`, the
    port with `--device cpu`, the reference with `--interpret`): the same
    printed lines apart from the loss log, and the loss trajectory within
    the 1e-3 relative of `test_training_matches_reference`.
  * `--out` is required, and a path inside either package's `data/`
    fails before any work; the shipped `onset_pitch.npz` is untouched.
"""

import contextlib
import hashlib
import importlib.util
import io
import os

import jax
import numpy as np
import pytest
import torch

from openwurli_tpu_torch import DATA_DIR
from openwurli_tpu_torch.calib import onset_model as om
from openwurli_tpu_torch.kernels import mono_chain as pmc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100.0
POOL_SECONDS = 0.01
N_TWINS = 3
HEAD = 16
SUM_DB = -80.0
ONSET_NPZ_SHA256 = \
    "333d19b2066a752d80cc4e9e01593c1ea6328ced99aa906612b1811360e933ea"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_train_onset_model",
             os.path.join(REPO, "tools", "torch_train_onset_model.py"))
ref_tool = _load("ref_train_onset_model",
                 os.path.join(REPO, "tools", "train_onset_model.py"))


def _db(err, sig):
    return 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30)
                           / np.sqrt(np.mean(sig ** 2)))


def _perturb(x, rng):
    """x scaled by (1 ± 2⁻²³) elementwise, random signs."""
    sign = rng.choice([-1.0, 1.0], size=x.shape)
    return (x * (1.0 + 2.0 ** -23 * sign)).astype(np.float32)


def _small_pool():
    """A pool of both timbre families and both key kinds, from seeded
    noise (the NumPy functions do not look at the audio's origin)."""
    rng = np.random.default_rng(4)
    pool = {}
    for m in (36, 60, 84):
        pool[(m, 0.7, 0.0)] = rng.normal(0, 0.1, 800).astype(np.float32)
        pool[(m, 0.7, "di")] = rng.normal(0, 0.1, 800).astype(np.float32)
    return pool


def test_numpy_parts_match_reference():
    sr = 16000.0
    a = tool.add_synthetic_tones(_small_pool(), sr, 0.5)
    b = ref_tool.add_synthetic_tones(_small_pool(), sr, 0.5)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
    clips = tool.synth_mixtures(a, sr, 6, 1.5, seed=3)
    ref_clips = ref_tool.synth_mixtures(b, sr, 6, 1.5, seed=3)
    assert len(clips) == len(ref_clips) == 6
    for (x, ev), (rx, rev) in zip(clips, ref_clips):
        assert ev == rev and len(ev) >= 1
        np.testing.assert_array_equal(x, rx)
    for x, ev in clips:
        for got, want in zip(tool.label_clip(x, ev, sr),
                             ref_tool.label_clip(x, ev, sr)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    # a label outside the keyboard is skipped in both
    x, _ = clips[0]
    for got, want in zip(tool.label_clip(x, [(0.2, 30), (0.5, 60)], sr),
                         ref_tool.label_clip(x, [(0.2, 30), (0.5, 60)], sr)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pools():
    """(port pool, reference pool, port voice sum, reference voice sum,
    reference twins) of the tiny render_note_pool."""
    from openwurli_tpu.kernels import mono_chain as jmc

    caught = {}
    render_cpu = jmc.render_cpu

    def chain(sr, ctrl, state, audio, interpret=False, t_tile=None,
              noise=False):
        # render_tpu's stand-in: the reference's plain chain over the
        # streams and N_TWINS perturbed copies in one call
        audio, state = np.asarray(audio), np.asarray(state)
        s, n = audio.shape[1], 1 + N_TWINS
        rng = np.random.default_rng(7)
        both = np.zeros((audio.shape[0], n * s), np.float32)
        st = np.tile(state, (1, n))
        n_float = jmc._OFFSETS["nz_lcg"][0]
        for i in range(n):
            cols = slice(i * s, (i + 1) * s)
            both[:, cols] = audio if i == 0 else _perturb(audio, rng)
            if i:
                st[:n_float, cols] = _perturb(st[:n_float, cols], rng)
        y, st_out = render_cpu(jmc.pack_consts(sr),
                               np.tile(np.asarray(ctrl), (1, n)), st, both)
        y = np.asarray(y)
        caught["ref_sum"] = audio
        caught["twins"] = [y[:, i * s:(i + 1) * s] for i in range(1, n)]
        return y[:, :s], np.asarray(st_out)[:, :s]

    render = pmc.render

    def port_chain(sr, ctrl, state, audio, noise=False):
        caught["port_sum"] = audio.numpy().copy()
        return render(sr, ctrl, state, audio, noise=noise)

    kw = dict(vels=(0.7,), midi_step=12, depths=(0.0,))
    with pytest.MonkeyPatch.context() as mp:
        # one 64-sample tile: the chain renders only what the pool keeps
        mp.setattr(jmc, "T_TILE", 64)
        mp.setattr(jmc, "render_tpu", chain)
        ref = ref_tool.render_note_pool(SR, POOL_SECONDS, True, **kw)
        mp.setattr(pmc, "T_TILE", 64)
        mp.setattr(pmc, "render", port_chain)
        port = tool.render_note_pool(SR, POOL_SECONDS, "cpu", **kw)
    return (port, ref, caught["port_sum"], caught["ref_sum"],
            caught["twins"])


def test_render_note_pool_matches_reference(pools):
    port, ref, port_sum, ref_sum, twins = pools
    n = int(POOL_SECONDS * SR)
    assert list(port) == list(ref) and len(port) == 12
    assert port_sum.shape == ref_sum.shape == (448, 6)
    keys = [k for k in ref if k[2] != "di"]
    for s, k in enumerate(keys):
        got, want = port[k], ref[k]
        assert got.dtype == np.float32 and got.shape == want.shape == (n,)
        assert np.isfinite(got).all()
        sum_db = _db(port_sum[:n, s] - ref_sum[:n, s], ref_sum[:n, s])
        head_db = _db(got[:HEAD] - want[:HEAD], want[:HEAD])
        head_sens = max(_db(tw[:HEAD, s] - want[:HEAD], want[:HEAD])
                        for tw in twins)
        db = _db(got - want, want)
        sens = max(_db(tw[:n, s] - want, want) for tw in twins)
        print(f"{k}: voice sum {sum_db:.1f} dB, head {head_db:.1f} dB "
              f"(twins {head_sens:.1f}), whole {db:.1f} dB (twins "
              f"{sens:.1f})")
        assert sum_db <= SUM_DB, (k, sum_db)
        assert head_db < head_sens + 3.0, (k, head_db, head_sens)
        assert db < sens + 3.0, (k, db, sens)
    for k in (k for k in ref if k[2] == "di"):
        got, want = port[k], ref[k]
        assert got.dtype == np.float32 and got.shape == want.shape == (n,)
        db = _db(got - want, want)
        print(f"{k}: {db:.1f} dB")
        assert db <= SUM_DB, (k, db)


def _printed(lines):
    """The printed lines apart from the loss log and the output path."""
    return [ln for ln in lines if not ln.startswith(("step ", "→ ",
                                                     "stage seconds"))]


def test_main_matches_reference(pools, tmp_path, monkeypatch):
    port_pool = pools[0]
    pool_npz = str(tmp_path / "pool.npz")
    np.savez_compressed(pool_npz, **{str(k): v for k, v in port_pool.items()})
    args = ["--sr", str(SR), "--clips", "8", "--steps", "20",
            "--pool-npz", pool_npz]

    port_losses, ref_losses = [], []
    loss_fn = om.loss_fn

    def recording_loss(*a, **k):
        loss = loss_fn(*a, **k)
        port_losses.append(float(loss.detach()))
        return loss

    out = io.StringIO()
    monkeypatch.setattr(om, "loss_fn", recording_loss)
    with contextlib.redirect_stdout(out):
        result = tool.main(args + ["--device", "cpu",
                                   "--out", str(tmp_path / "port.npz")])
    monkeypatch.setattr(om, "loss_fn", loss_fn)
    port_lines = out.getvalue().splitlines()

    real_jit = jax.jit

    def recording_jit(f, **kw):
        jf = real_jit(f, **kw)
        if getattr(f, "__name__", "") != "step":  # optax's own jits
            return jf

        def step(*a):
            res = jf(*a)
            ref_losses.append(float(res[2]))
            return res
        return step

    out = io.StringIO()
    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr("sys.argv", ["train_onset_model.py"] + args + [
        "--interpret", "--out", str(tmp_path / "ref.npz")])
    with contextlib.redirect_stdout(out):
        ref_tool.main()
    monkeypatch.setattr(jax, "jit", real_jit)
    ref_lines = out.getvalue().splitlines()

    print("\n".join(port_lines))
    assert _printed(port_lines) == _printed(ref_lines)
    assert port_lines[0] == "loaded pool: 12 notes"
    a, b = np.asarray(port_losses), np.asarray(ref_losses)
    assert a.shape == b.shape == (20,)
    gap = np.max(np.abs(a - b) / np.abs(b))
    print(f"loss trajectory: worst relative gap {gap:.3g}")
    assert gap <= 1e-3
    saved = om.load_params(str(tmp_path / "port.npz"))
    assert saved is not None and int(saved["fmt"][0]) == 3
    for k, v in result["params"].items():
        np.testing.assert_array_equal(saved[k], v)
    assert set(result["seconds"]) == {"pool", "mixtures", "train",
                                      "network eval", "spectral eval"}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("out", [None, "port", "reference", "subdir"])
def test_out_is_required_outside_the_packages_data(out, capsys):
    shipped = os.path.join(DATA_DIR, "onset_pitch.npz")
    ref_shipped = os.path.join(REPO, "openwurli_tpu", "data",
                               "onset_pitch.npz")
    before = (_sha(shipped), _sha(ref_shipped))
    argv = ["--device", "cpu", "--clips", "1", "--steps", "1"]
    if out == "port":
        argv += ["--out", shipped]
    elif out == "reference":
        argv += ["--out", ref_shipped]
    elif out == "subdir":
        argv += ["--out", os.path.join(REPO, "openwurli_tpu_torch", "data",
                                       "..", "data", "x", "op.npz")]
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code == 2
    assert "--out" in capsys.readouterr().err
    assert (_sha(shipped), _sha(ref_shipped)) == before
    assert before[0] == ONSET_NPZ_SHA256
