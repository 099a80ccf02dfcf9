"""Native (C++) audio data loader — ctypes bindings, built on first use.

Port of `openwurli_tpu/native/__init__.py`. `wav_loader.cpp` (a copy of
the reference's) is compiled with g++ on first use into
build/openwurli_tpu_torch/, one library per source hash, never next to the
source. This is a host-side file reader, not a device kernel: when the
library cannot be built or loaded, `get_lib()` is None and the callers
(`io.wav.read_wav_mono`) take their pure-NumPy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from openwurli_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "wav_loader.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_tried = False

_PD = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "wurli_decode_wav": (ctypes.c_longlong, [
        ctypes.c_char_p, _PD, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int)]),
    "wurli_encode_wav": (ctypes.c_int, [
        ctypes.c_char_p, _PD, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int]),
    "wurli_frame_stats": (ctypes.c_longlong, [
        _PD, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, _PD,
        _PD]),
}


def lib_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"{h.hexdigest()[:16]}-libwurli_native.so")


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                   capture_output=True)
    os.replace(tmp, path)


def get_lib():
    """The loaded native library, or None if the build or load fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(x):
    return x.ctypes.data_as(_PD)


def decode_wav(path):
    """Native WAV decode → (mono float64 array, sample_rate) or None."""
    lib = get_lib()
    if lib is None:
        return None
    sr = ctypes.c_int(0)
    n = lib.wurli_decode_wav(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        return None
    out = np.empty(n, dtype=np.float64)
    written = lib.wurli_decode_wav(path.encode(), _ptr(out), n,
                                   ctypes.byref(sr))
    if written != n:
        return None
    return out, sr.value


def encode_wav(path, x, sample_rate, bits=24):
    """Native mono WAV encode. Returns True on success."""
    lib = get_lib()
    if lib is None:
        return False
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.ndim != 1:
        return False
    rc = lib.wurli_encode_wav(path.encode(), _ptr(x), x.shape[0],
                              int(sample_rate), int(bits))
    return rc == 0


def frame_stats(x, frame, hop):
    """Framed (rms, peak) envelopes, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.shape[0] < frame:
        return np.zeros(0), np.zeros(0)
    n_frames = 1 + (x.shape[0] - frame) // hop
    rms = np.empty(n_frames, dtype=np.float64)
    peak = np.empty(n_frames, dtype=np.float64)
    got = lib.wurli_frame_stats(_ptr(x), x.shape[0], frame, hop, _ptr(rms),
                                _ptr(peak))
    if got != n_frames:
        return None
    return rms, peak
