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


def test_imports_without_jax():
    code = ("import sys, openwurli_tpu_torch, openwurli_tpu_torch.fast, "
            "openwurli_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'openwurli_tpu' "
            "or m.startswith('openwurli_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _package_files():
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


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


def test_cuda_wrappers_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        vb.make_kernel_params([60.0], [0.8], 44100.0, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        mc.init_state(44100.0, 2, device="cuda")
    from openwurli_tpu_torch import fast
    with pytest.raises((RuntimeError, AssertionError)):
        fast.render_grid([[60.0]], 0.8, 0.01, device="cuda")


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
    with pytest.raises(NotImplementedError, match="K3"):
        vb.render_voice_bank(p, 64, events=True)
    ctrl = mc.make_controls(44100.0, 2)
    st = mc.init_state(44100.0, 2)
    audio = torch.zeros((4, 2))
    with pytest.raises(NotImplementedError, match="K5"):
        mc.render(44100.0, ctrl, st, audio, noise=True)
    with pytest.raises(ValueError):
        mc.render(44100.0, ctrl, st, torch.zeros((3, 2)))
    with pytest.raises(ValueError):
        mc.render(44100.0, ctrl[:, :1].contiguous(), st, audio)
    with pytest.raises(TypeError):
        mc.render(44100.0, ctrl, st, audio.double())


def test_build_needs_nvcc():
    if _build.shutil.which("nvcc") or os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_unknown_tremolo_rate_raises():
    with pytest.raises(NotImplementedError, match="slice 4"):
        tremolo.settled_osc_state(22050.0)


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

    ctrl = dict(e.split(" = ") for e in _cu_enum("Ctrl"))
    for name, key in (("volume", "C_VOLUME"), ("rail_sag", "C_RAIL_SAG"),
                      ("div_top", "C_DIV_TOP"), ("r_lower", "C_R_LOWER"),
                      ("hpf", "C_HPF"), ("lpf", "C_LPF"), ("a2", "C_A2"),
                      ("a3", "C_A3"), ("thermal_coeff", "C_THERMAL"),
                      ("char", "C_CHAR")):
        assert int(ctrl[key]) == mc._CTRL_OFF[name][0], name
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
