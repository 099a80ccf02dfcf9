"""Builds and loads the port's CUDA kernels (csrc/*.cu) on first use.

`nvcc` compiles every source under csrc/ into one shared library with a
plain C interface, build/openwurli_tpu_torch/libowkernels.so next to the
package, rebuilt whenever a source's content hash changes; the library is
loaded with ctypes and its entry points get explicit argtypes. Nothing
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
SOURCES = ("voice_bank.cu", "mono_chain.cu")
# -fmad=false: no FMA contraction anywhere, so the kernels round like their
# plain torch twins (and the compensated sums in mono_chain.cu stay exact).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of the last nvcc run in this process

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # params, state_in, out, state_out, lanes, total, t_tile, n0,
    # steady0, steady1, stream
    "ow_voice_bank": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    # consts, n_consts, scalars, n_scalars, controls, state_in, audio, out,
    # state_out, streams, t_len, stream
    "ow_mono_chain": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
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
    global BUILD_SECONDS
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{source_hash()}-{LIB_NAME}")
    if os.path.exists(lib_path):
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC_DIR, s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
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
