"""The PyTorch port's package boundary: it imports without JAX, its CUDA
wrappers never fall back to the CPU, and the CUDA sources agree with the
Python layouts they are handed."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import openwurli_tpu_torch
from openwurli_tpu_torch import _build
from openwurli_tpu_torch.circuits import tremolo
from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb

torch.set_num_threads(1)

PKG_DIR = os.path.dirname(openwurli_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
# the port's tools, each a script under tools/
TOOLS = ("torch_probe", "torch_interactive_rtf", "torch_k4_breakdown",
         "torch_vb_breakdown", "torch_melange_breakdown",
         "torch_dk_breakdown", "torch_mna_breakdown", "torch_voice_breakdown",
         "torch_strip_pedal", "torch_analyze_pump_dynamics",
         "torch_h3_analysis", "torch_wurli_compare",
         "torch_recording_analyzer", "torch_gen_settled_states",
         "torch_perf_sweep", "torch_engine_chunk", "torch_stage_bench",
         "torch_export_spice", "torch_train_onset_model")


def test_imports_without_jax():
    code = ("import sys, openwurli_tpu_torch, openwurli_tpu_torch.fast, "
            "openwurli_tpu_torch.convert, openwurli_tpu_torch.io.midi_file, "
            "openwurli_tpu_torch.io.wav, openwurli_tpu_torch.fast_engine, "
            "openwurli_tpu_torch.host, openwurli_tpu_torch.stream_host, "
            "openwurli_tpu_torch.kernels.probe, openwurli_tpu_torch.engine, "
            "openwurli_tpu_torch.kernels.engine, "
            "openwurli_tpu_torch.ops.exact, openwurli_tpu_torch.di, "
            "openwurli_tpu_torch.kernels.render, "
            "openwurli_tpu_torch.circuits.melange_preamp, "
            "openwurli_tpu_torch.circuits.power_amp, "
            "openwurli_tpu_torch.prng, "
            "openwurli_tpu_torch.calib.goertzel, "
            "openwurli_tpu_torch.calib.harmonics, "
            "openwurli_tpu_torch.calib.notes, "
            "openwurli_tpu_torch.calib.onset_model, "
            "openwurli_tpu_torch.calib.train, "
            "openwurli_tpu_torch.calib.residuals, "
            "openwurli_tpu_torch.calib.alias_audit, "
            "openwurli_tpu_torch.calib.calibrate, "
            "openwurli_tpu_torch.calib.pipeline, openwurli_tpu_torch.cli, "
            "openwurli_tpu_torch.native, openwurli_tpu_torch.entry, "
            "openwurli_tpu_torch.parallel.mesh, "
            "openwurli_tpu_torch.parallel.dryrun\n"
            "import runpy\n"
            "for tool in TOOLS:\n"
            "    runpy.run_path(f'tools/{tool}.py')\n"
            "from openwurli_tpu_torch import fast\n"
            "for name in ('schedule_events', 'render_events', "
            "'render_events_parallel', 'render_midi_file', "
            "'_voice_lifetimes', '_song_voices', '_scatter_voices', "
            "'_segment_windows', 'VOICE_TIMEOUT_S'):\n"
            "    assert hasattr(fast, name), name\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'openwurli_tpu' "
            "or m.startswith('openwurli_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    code = f"TOOLS = {TOOLS!r}\n" + code
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _package_files():
    """The package's modules, the card script and the port's tools."""
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for tool in TOOLS:
        yield os.path.join(REPO, "tools", f"{tool}.py")


def test_no_file_imports_jax_or_the_reference():
    offenders = []
    for path in _package_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "openwurli_tpu"):
                    offenders.append((path, m))
    assert not offenders, offenders


def test_cuda_wrappers_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        vb.make_kernel_params([60.0], [0.8], 44100.0, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        mc.init_state(44100.0, 2, device="cuda")
    from openwurli_tpu_torch import fast
    with pytest.raises((RuntimeError, AssertionError)):
        fast.render_grid([[60.0]], 0.8, 0.01, device="cuda")
    # the event renderers default to the card as well
    with pytest.raises((RuntimeError, AssertionError)):
        fast.render_events([60.0], [0.8], [0.0], [100.0], 0.01)
    with pytest.raises((RuntimeError, AssertionError)):
        fast.render_events_parallel([60.0], [0.8], [0.0], [100.0], 0.01)
    with pytest.raises((RuntimeError, AssertionError)):
        mc.trem_preroll(44100.0, mc.make_controls(44100.0, 1,
                                                  device="cuda"), 2, 8)
    # the interactive entry points default to the card as well
    from openwurli_tpu_torch import fast_engine, host, stream_host
    with pytest.raises((RuntimeError, AssertionError)):
        fast_engine.FastEngine(44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        host.FastWurliPlugin(44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        stream_host.StreamHost(engine="fast")
    with pytest.raises((RuntimeError, AssertionError)):
        stream_host.play_midi("none.mid", None, engine="fast")
    # and the f64 engine
    from openwurli_tpu_torch import engine
    with pytest.raises((RuntimeError, AssertionError)):
        engine.Engine(44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        host.WurliPlugin(44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        engine.Engine(44100.0, preamp_model="melange", pa_model="behavioral")
    with pytest.raises((RuntimeError, AssertionError)):
        host.WurliPlugin(44100.0, preamp_model="melange")
    # and the DI render path
    from openwurli_tpu_torch import di, voice
    with pytest.raises((RuntimeError, AssertionError)):
        voice.render_note(60.0, 0.8, 0.01, 44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        di.render_di([60.0], [0.8], 0.01, 44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        di.preamp_di(np.zeros(8), 44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        di.preamp_di(torch.zeros(8, dtype=torch.float64), 44100.0)
    # and the calibration pipeline
    from openwurli_tpu_torch.calib import (alias_audit, calibrate, goertzel,
                                           harmonics, onset_model, pipeline)
    with pytest.raises((RuntimeError, AssertionError)):
        calibrate.run_calibrate([60], [100])
    with pytest.raises((RuntimeError, AssertionError)):
        goertzel.dft_magnitude(np.zeros(64), [440.0], 44100.0)
    with pytest.raises((RuntimeError, AssertionError)):
        harmonics.measure_interharmonic_snr(np.zeros(44100), 44100.0, 440.0)
    with pytest.raises((RuntimeError, AssertionError)):
        alias_audit.analyze(np.zeros(22050), 44100.0, 440.0)
    with pytest.raises((RuntimeError, AssertionError)):
        onset_model.predict(onset_model.init_params(0), np.zeros(8192),
                            44100.0)
    np.savez(tmp_path / "training_data.npz", inputs=np.zeros((2, 2)),
             targets=np.zeros((2, 11)), mask=np.ones((2, 11), bool),
             weights=np.ones(2))
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.main(["--from-stage", "6", "--through-stage", "6",
                       "--data-dir", str(tmp_path)])
    # and the CLI, whose --device defaults to the card
    from openwurli_tpu_torch import cli
    from openwurli_tpu_torch.kernels import render as kr
    for argv in (["gain"], ["pump-spike"], ["reed-render", "--duration",
                                            "0.01"]):
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(argv)
    with pytest.raises((RuntimeError, AssertionError)):
        kr.init_dk_scan_state(88200.0, 2, "cuda")
    # and the batched engine's sweep, whose --device defaults to the card
    import runpy
    sweep = runpy.run_path(os.path.join(REPO, "tools",
                                        "torch_perf_sweep.py"))
    with pytest.raises((RuntimeError, AssertionError)):
        sweep["main"](["--streams", "1", "--seconds", "0.001"])
    chunk = runpy.run_path(os.path.join(REPO, "tools",
                                        "torch_engine_chunk.py"))
    with pytest.raises((RuntimeError, AssertionError)):
        chunk["main"](["--history", "1", "--chord-s", "0.001",
                       "--warm-up-s", "0.001"])
    # and the stage benchmark (E8, E9), whose --device defaults to the card
    from openwurli_tpu_torch.kernels import engine as ek
    stage = runpy.run_path(os.path.join(REPO, "tools",
                                        "torch_stage_bench.py"))
    with pytest.raises((RuntimeError, AssertionError)):
        stage["main"](["--batch", "1", "--samples", "2", "--reps", "1"])
    with pytest.raises((RuntimeError, AssertionError)):
        ek.init_tremolo_scan_state(88200.0, 2, "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        ek.init_power_amp_scan_state(88200.0, 2, "cuda")
    # and the multi-device path: a CUDA mesh never falls back to gloo or
    # to the CPU, and the entry points default to the card
    from openwurli_tpu_torch import entry
    from openwurli_tpu_torch.parallel import dryrun, mesh
    for devices in (None, ["cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh(devices)
    assert not torch.distributed.is_initialized()
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()
    for run in (lambda: dryrun.main(1), lambda: dryrun.cli(["1"]),
                lambda: entry.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            run()
    onset = runpy.run_path(os.path.join(REPO, "tools",
                                        "torch_train_onset_model.py"))
    with pytest.raises((RuntimeError, AssertionError)):
        onset["main"](["--clips", "1", "--steps", "1", "--out",
                       str(tmp_path / "op.npz")])


def test_wrappers_reject_other_devices_and_bad_inputs():
    p, _ = vb.make_kernel_params([60.0], [0.8], 44100.0)
    with pytest.raises(ValueError, match="unsupported device"):
        vb.render_voice_bank(p.to("meta"), 64)
    with pytest.raises(TypeError):
        vb.render_voice_bank(p.double(), 64)
    with pytest.raises(ValueError):
        vb.render_voice_bank(p[..., :64], 64, state=vb.init_bank_state(p))
    with pytest.raises(ValueError, match="multiple of 16"):
        vb.render_voice_bank(p, 64, n0=8)
    assert vb.render_voice_bank(p, 64, events=True).shape == (64, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        vb.render_voice_bank(p.to("meta"), 64, events=True,
                             min_release=vb.NEVER)
    ctrl = mc.make_controls(44100.0, 2)
    st = mc.init_state(44100.0, 2)
    audio = torch.zeros((4, 2))
    # the thermal-noise variant (K5) runs: its plain version on the CPU
    out, st_n = mc.render(44100.0, ctrl, st, audio, noise=True)
    assert out.shape == (4, 2) and st_n.shape == st.shape
    with pytest.raises(ValueError, match="unsupported device"):
        mc.render(44100.0, ctrl.to("meta"), st.to("meta"),
                  audio.to("meta"), noise=True)
    with pytest.raises(ValueError):
        mc.render(44100.0, ctrl, st, torch.zeros((3, 2)))
    with pytest.raises(ValueError):
        mc.render(44100.0, ctrl[:, :1].contiguous(), st, audio)
    with pytest.raises(TypeError):
        mc.render(44100.0, ctrl, st, audio.double())
    # E8 and E9
    from openwurli_tpu_torch.kernels import engine as ek
    trem = ek.init_tremolo_scan_state(88200.0, 2)
    depth = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.tremolo_scan(88200.0, trem.to("meta"), depth.to("meta"), 4)
    with pytest.raises(ValueError, match="one device"):
        ek.tremolo_scan(88200.0, trem, depth.to("meta"), 4)
    pa = ek.init_power_amp_scan_state(88200.0, 2)
    x = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.power_amp_scan(88200.0, x.to("meta"), pa.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        ek.power_amp_scan(88200.0, x, pa.to("meta"))


def test_build_needs_nvcc():
    if _build.shutil.which("nvcc") or os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_unknown_tremolo_rate_raises():
    """A rate missing from the package data is settled on the card by
    default (kernel E3): without a card that raises, and nothing falls
    back to the CPU's plain loop."""
    from openwurli_tpu_torch.kernels import engine as ek

    if torch.cuda.is_available():
        pytest.skip("a card is present: the settle would succeed")
    calls = ek.SETTLE_PLAIN_CALLS
    with pytest.raises((RuntimeError, AssertionError)):
        tremolo.settled_osc_state(22050.0)
    assert ek.SETTLE_PLAIN_CALLS == calls


def test_build_signatures_cover_every_entry_point():
    """Every extern "C" function of the CUDA sources has its ctypes
    signature, with as many arguments as the C declaration."""
    found = {}
    for src in _build.SOURCES:
        with open(os.path.join(PKG_DIR, "csrc", src)) as f:
            text = f.read()
        for name, args in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                     text, re.S):
            found[name] = len(args.split(","))
    assert set(found) == set(_build._SIGNATURES) == {
        "ow_voice_bank", "ow_voice_bank_events", "ow_mono_chain",
        "ow_mono_chain_noise", "ow_trem_preroll", "ow_probe",
        "ow_engine_voices", "ow_engine_voices_thread", "ow_engine_chain",
        "ow_tremolo_settle",
        "ow_voice_render", "ow_preamp_scan", "ow_voice_render_tap",
        "ow_pa_speaker_scan", "ow_dk_scan", "ow_tremolo_scan",
        "ow_power_amp_scan"}
    for name, n_args in found.items():
        assert len(_build._SIGNATURES[name]) == n_args, name


def test_preroll_capture_layout_matches_cuda():
    """The pre-roll kernel's capture order is preroll_rows()."""
    with open(os.path.join(PKG_DIR, "csrc", "mono_chain.cu")) as f:
        src = f.read()
    body = re.search(r"kPrerollSpans\[7\]\[2\] = \{(.*?)\};", src,
                     re.S).group(1)
    spans = re.findall(r"\{ST_(\w+), (\d+)\}", body)
    assert [(n.lower(), int(r)) for n, r in spans] == \
        [(name, b - a) for name, a, b, _ca, _cb in mc.preroll_rows()]
    assert "PREROLL_ROWS = %d;" % mc.PREROLL_ROWS in src


def _cu_enum(name):
    with open(os.path.join(PKG_DIR, "csrc", "mono_chain.cu")) as f:
        src = f.read()
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    return [x.strip() for x in body.replace("\n", " ").split(",")
            if x.strip()]


def test_cuda_layouts_match_python():
    scal = _cu_enum("Sc")
    assert scal[-1] == "N_SCALARS"
    assert [s.lower() for s in scal[:-1]] == list(mc.SCALAR_NAMES)
    # appended last: no index of the earlier kernels' scalars moved
    assert mc.SCALAR_NAMES[-2:] == ("drive", "nz_u_sigma")

    consts = mc.pack_consts(44100.0)
    offs = dict(e.split(" = ") for e in _cu_enum("ArrayOffset"))
    off = 0
    for name in mc.ARRAY_NAMES:
        assert int(offs["A_" + name.upper()]) == off, name
        off += consts.arrays[name].size
    assert int(offs["A_TOTAL"]) == off

    st = dict(e.split(" = ") for e in _cu_enum("StateOffset"))
    for name, (a, _b) in mc._OFFSETS.items():
        assert int(st["ST_" + name.upper()]) == a, name
    assert int(st["STATE_ROWS"]) == mc.STATE_ROWS

    # every entry of STATE_SPEC has its name in the enum, and no other
    assert sorted(st) == sorted(["ST_" + n.upper() for n, _ in mc.STATE_SPEC]
                                + ["STATE_ROWS"])

    # every entry of CTRL_SPEC likewise (thermal_coeff is C_THERMAL)
    ctrl = dict(e.split(" = ") for e in _cu_enum("Ctrl"))
    keys = {name: "C_" + name.upper() for name, _ in mc.CTRL_SPEC}
    keys["thermal_coeff"] = "C_THERMAL"
    for name, key in keys.items():
        assert int(ctrl[key]) == mc._CTRL_OFF[name][0], name
    assert int(ctrl["C_NOISE"]) == 18
    assert sorted(ctrl) == sorted(list(keys.values()) + ["CTRL_ROWS"])
    assert int(ctrl["CTRL_ROWS"]) == mc.CTRL_ROWS

    with open(os.path.join(PKG_DIR, "csrc", "mono_chain.cu")) as f:
        src = f.read()
    for name, ports in (("kPaActive", mc.PA_ACTIVE),
                        ("kPaReleg", mc.PA_RELEG)):
        body = re.search(name + r"\[N_\w+\] = \{(.*?)\}", src).group(1)
        assert tuple(int(x) for x in body.split(",")) == ports


def test_voice_bank_lcg_constants_match():
    with open(os.path.join(PKG_DIR, "csrc", "voice_bank.cu")) as f:
        src = f.read()
    for name, vals in (("kLcgAPow", vb.LCG_A_POW[1:8]),
                       ("kLcgCAcc", vb.LCG_C_ACC[1:8])):
        body = re.search(name + r"\[NM\] = \{(.*?)\};", src, re.S).group(1)
        got = [int(x.strip().rstrip("u")) for x in body.split(",")]
        assert got == vals, name


def test_convert_round_trips_bit_rows():
    p, _ = vb.make_kernel_params([60.0, 72.0], [0.8, 0.5], 44100.0)
    from openwurli_tpu_torch import convert
    q = convert.voice_params_from_numpy(p.numpy())
    assert torch.equal(q.view(torch.int32), p.view(torch.int32))
    st = convert.state_from_numpy(mc.init_state(44100.0, 3).numpy())
    assert st.shape == (mc.STATE_ROWS, 3)
    with pytest.raises(ValueError):
        convert.state_from_numpy(np.zeros((7, 3)))


def test_probe_bodies_match_cuda():
    """The probe kernel's body indices are kernels/probe.py BODIES."""
    from openwurli_tpu_torch.kernels import probe

    with open(os.path.join(PKG_DIR, "csrc", "probe.cu")) as f:
        src = f.read()
    body = re.search(r"enum Body \{(.*?)\};", src, re.S).group(1)
    names = [x.strip().lower() for x in body.replace("\n", " ").split(",")]
    assert names == list(probe.BODIES) + ["n_bodies"]
    for name, val in (("MAX_SUB", probe.MAX_SUB), ("MAX_M", probe.MAX_M),
                      ("OUT_LANES", probe.OUT_LANES)):
        assert re.search(r"%s = %d;" % (name, val), src), name
    assert "GE_N = %d, GE_W = %d;" % (probe.GE_N, probe.GE_W) in src
    assert "probe.cu" in _build.SOURCES
