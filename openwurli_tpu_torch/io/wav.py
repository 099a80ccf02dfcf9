"""WAV I/O (16/24-bit PCM + float32), pure NumPy.

Copy of `openwurli_tpu/io/wav.py` without its optional native decoder:
`read_wav_mono` always takes the NumPy reader.
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav_mono(path):
    """(mono float64 array, sample_rate); channels are averaged."""
    x, sr = read_wav(path)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, sr


def write_wav(path, samples, sample_rate, bits=24):
    """Write mono or (n, ch) float samples in [-1, 1] to a PCM WAV."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    sr = int(sample_rate)
    x = np.clip(x, -1.0, 1.0)

    if bits == 16:
        data = (x * 32767.0).astype("<i2").tobytes()
        block = 2 * ch
        fmt_tag = 1
    elif bits == 24:
        i32 = (x * 8388607.0).astype("<i4")
        b = i32.astype("<i4").tobytes()
        arr = np.frombuffer(b, dtype=np.uint8).reshape(-1, 4)
        data = arr[:, :3].tobytes()
        block = 3 * ch
        fmt_tag = 1
    elif bits == 32:
        data = x.astype("<f4").tobytes()
        block = 4 * ch
        fmt_tag = 3
    else:
        raise ValueError(f"unsupported bit depth {bits}")

    with open(path, "wb") as f:
        byte_rate = sr * block
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_tag, ch, sr, byte_rate,
                            block, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path):
    """Read a PCM/float WAV → (float64 array [n] or [n, ch], sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a WAV file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: WAV file without fmt or data chunk")
    fmt_tag, ch, sr, _rate, _block, bits = fmt
    if fmt_tag == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float64)
    elif fmt_tag == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float64) / 32768.0
    elif fmt_tag == 1 and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        x = i32.astype(np.float64) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV format {fmt_tag}/{bits}")
    if ch > 1:
        x = x.reshape(-1, ch)
    return x, sr
