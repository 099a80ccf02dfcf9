"""The PyTorch port's native C++ audio loader (`openwurli_tpu_torch.native`,
built with g++ into build/openwurli_tpu_torch/ on first use): the cases of
tests/test_native.py on the port's loader and `io.wav`, and the port's
decode of a file the reference's native encoder wrote, equal bit for bit
to the reference's decode."""

import os

import numpy as np
import pytest

from openwurli_tpu import native as jnative
from openwurli_tpu_torch import _build, native
from openwurli_tpu_torch.io import wav


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native library unavailable (no g++?)")
    return True


def test_library_builds_outside_the_source_tree(lib_available):
    path = native.lib_path()
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)
    assert not any(f.endswith(".so") for f in
                   os.listdir(os.path.dirname(native.__file__)))


def test_roundtrip_24bit_matches_python(tmp_path, lib_available):
    sr = 44100
    t = np.arange(4096) / sr
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    path = str(tmp_path / "t.wav")

    assert native.encode_wav(path, x, sr, bits=24)
    nx, nsr = native.decode_wav(path)
    px, psr = wav.read_wav(path)
    assert nsr == psr == sr
    np.testing.assert_allclose(nx, px, atol=1e-12)
    np.testing.assert_allclose(nx, x, atol=2.0 / (1 << 23))


def test_native_decode_matches_python_on_python_encode(tmp_path,
                                                       lib_available):
    sr = 48000
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, 2000)
    for bits in (16, 24, 32):
        path = str(tmp_path / f"t{bits}.wav")
        wav.write_wav(path, x, sr, bits=bits)
        nx, nsr = native.decode_wav(path)
        px, psr = wav.read_wav(path)
        assert nsr == psr == sr
        np.testing.assert_allclose(nx, px, atol=1e-12)


def test_stereo_mono_mixdown(tmp_path, lib_available):
    sr = 44100
    left = np.ones(100) * 0.5
    right = np.ones(100) * -0.25
    wav.write_wav(str(tmp_path / "st.wav"), np.stack([left, right], axis=1),
                  sr, bits=16)
    nx, _ = native.decode_wav(str(tmp_path / "st.wav"))
    np.testing.assert_allclose(nx, 0.125, atol=1e-4)


def test_frame_stats(lib_available):
    x = np.concatenate([np.zeros(512), np.ones(512)])
    rms, peak = native.frame_stats(x, 256, 256)
    np.testing.assert_allclose(rms, [0.0, 0.0, 1.0, 1.0], atol=1e-12)
    np.testing.assert_allclose(peak, [0.0, 0.0, 1.0, 1.0], atol=1e-12)


def test_read_wav_mono_helper(tmp_path):
    sr = 44100
    x = np.sin(2 * np.pi * 220.0 * np.arange(1000) / sr) * 0.3
    wav.write_wav(str(tmp_path / "m.wav"), x, sr, bits=24)
    y, ysr = wav.read_wav_mono(str(tmp_path / "m.wav"))
    assert ysr == sr
    np.testing.assert_allclose(y, x, atol=2.0 / (1 << 23))


@pytest.mark.parametrize("bits", [16, 24])  # the encoder's two depths
def test_decode_of_reference_encode_bit_identical(tmp_path, lib_available,
                                                  bits):
    if not jnative.available():
        pytest.skip("the reference's native library is unavailable")
    sr = 44100
    x = np.random.default_rng(bits).uniform(-0.95, 0.95, 3001)
    path = str(tmp_path / "ref.wav")
    assert jnative.encode_wav(path, x, sr, bits=bits)
    port, psr = native.decode_wav(path)
    ref, rsr = jnative.decode_wav(path)
    assert psr == rsr == sr
    assert port.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(port.view(np.int64), ref.view(np.int64))
    # io.wav.read_wav_mono takes the native decoder
    mono, _ = wav.read_wav_mono(path)
    np.testing.assert_array_equal(mono.view(np.int64), ref.view(np.int64))
    rms, peak = native.frame_stats(port, 512, 256)
    ref_rms, ref_peak = jnative.frame_stats(ref, 512, 256)
    np.testing.assert_array_equal(rms, ref_rms)
    np.testing.assert_array_equal(peak, ref_peak)
