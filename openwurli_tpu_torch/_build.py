"""Builds and loads the port's CUDA kernels (csrc/*.cu) on first use.

`nvcc` compiles every source under csrc/ to an object file, one process
per source, all started together, and links them into one shared library
with a plain C interface, build/openwurli_tpu_torch/libowkernels.so next to
the package, rebuilt whenever a source's content hash changes; the library
is loaded with ctypes and its entry points get explicit argtypes. Nothing
here runs at import time: the first CUDA call of a kernel wrapper calls
`library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "openwurli_tpu_torch")
LIB_NAME = "libowkernels.so"
SOURCES = ("voice_bank.cu", "mono_chain.cu", "probe.cu", "engine.cu")
# -fmad=false: no FMA contraction anywhere, so the kernels round like their
# plain torch twins (and the compensated sums in mono_chain.cu stay exact).
# -Xptxas -v: registers, stack and spills of each kernel go to the log.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of the last nvcc run in this process
BUILD_LOG = None      # its output: ptxas' registers, stack and spills

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # params, state_in, out, state_out, lanes, total, t_tile, n0,
    # steady0, steady1, stream
    "ow_voice_bank": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    # the same, with min_release before the stream
    "ow_voice_bank_events": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P),
    # consts, n_consts, scalars, n_scalars, controls, state_in, audio, out,
    # state_out, streams, t_len, stream
    "ow_mono_chain": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    # the same arguments: the thermal-noise variant
    "ow_mono_chain_noise": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    # consts, n_consts, scalars, n_scalars, controls, state_in, caps,
    # n_captures, steps_per_capture, stream
    "ow_trem_preroll": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _P),
    # body, x, mat, iters, depth, sub, lanes, threads, out, aux, stream
    "ow_probe": (_I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # vpar, vst, vsti, eng_i, mono, n, engines, fade_len, sample_rate,
    # stream
    "ow_engine_voices": (_P, _P, _P, _P, _P, _I, _I, _D, _D, _P),
    # the same arguments: E1's thread form (a thread per slot)
    "ow_engine_voices_thread": (_P, _P, _P, _P, _P, _I, _I, _D, _D, _P),
    # consts, n_consts, mono, chain, out, n, engines, rail_sag (bool per
    # engine), pre_model, pa_model, noise_scale (float64 per engine), warp
    # (1: a warp per engine, the circuit power amp only), stream
    "ow_engine_chain": (_P, _I, _P, _P, _P, _I, _I, _P, _I, _I, _P, _I, _P),
    # consts, n_consts, state, n_steps, stream
    "ow_tremolo_settle": (_P, _I, _P, _I, _P),
    # vpar, vst, vsti, out, voices, n, stream
    "ow_voice_render": (_P, _P, _P, _P, _I, _I, _P),
    # vpar, vst, vsti, out, reed, voices, n, stream
    "ow_voice_render_tap": (_P, _P, _P, _P, _P, _I, _I, _P),
    # consts, n_consts, x, state, out, n, streams, volume, character, stream
    "ow_pa_speaker_scan": (_P, _I, _P, _P, _P, _I, _I, _D, _D, _P),
    # kind, consts, n_consts, x, state, g_ldr, noise_scale, out, n,
    # streams, stream
    "ow_preamp_scan": (_I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    # tap, consts, n_consts, x, r_ldr, state, out, n, streams, stream
    "ow_dk_scan": (_I, _P, _I, _P, _P, _P, _P, _I, _I, _P),
    # consts, n_consts, state, depth, out, n, circuits, stream
    "ow_tremolo_scan": (_P, _I, _P, _P, _P, _I, _I, _P),
    # consts, n_consts, x, state, out, n, streams, stream
    "ow_power_amp_scan": (_P, _I, _P, _P, _P, _I, _I, _P),
}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if the library for their hash is missing;
    returns the library path."""
    global BUILD_SECONDS, BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{source_hash()}-{LIB_NAME}")
    if os.path.exists(lib_path):
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = f"{tmp}.{name}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
               os.path.join(CSRC_DIR, name)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, out)
    if failed is None:
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (proc.returncode, cmd, logs[-1])
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = "".join(logs)
    if failed is not None:
        code, cmd, out = failed
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib_path)
    link = os.path.join(BUILD_DIR, LIB_NAME)
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(os.path.basename(lib_path), link)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def error(code: int) -> str:
    return f"cudaError {code} (see cuda_runtime_api.h)"
