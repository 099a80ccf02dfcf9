"""Single-bin spectral estimation: exact DFT magnitudes of many harmonics
of many signals at once, in float64 on a device.

Port of `openwurli_tpu/calib/goertzel.py`. The reference computes these
outside any Pallas kernel, as one einsum; so does the port. Tensors stay
on their device; NumPy input goes to `device` (the card unless the caller
names another).
"""

from __future__ import annotations

import math

import torch

from openwurli_tpu_torch.ops import exact


def as_f64(x, device=None):
    """x (NumPy, a list or a tensor) → float64 tensor on `device` (None:
    a tensor's own device, else the card)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    return torch.as_tensor(x, dtype=torch.float64).to(device)


def dft_magnitude(signal, freqs, sample_rate, device=None):
    """Exact single-bin DFT magnitudes.

    signal: (..., n) — batch of time series.
    freqs: (k,) or (..., k) — target frequencies per batch element.
    Returns (..., k) amplitude estimates (2/n · |Σ x e^{-jωt}|, the
    sine-amplitude convention of the reference tests).
    """
    signal = as_f64(signal, device)
    freqs = as_f64(freqs, signal.device)
    n = signal.shape[-1]
    t = exact.div(torch.arange(n, dtype=torch.float64,
                               device=signal.device), float(sample_rate))
    ph = 2.0 * math.pi * freqs[..., None] * t  # (..., k, n)
    re = torch.einsum("...n,...kn->...k", signal, torch.cos(ph))
    im = torch.einsum("...n,...kn->...k", signal, torch.sin(ph))
    return exact.div(2.0 * torch.sqrt(re ** 2 + im ** 2), float(n))


def refine_f0(signal, f0_guess, sample_rate, span_hz=5.0, steps=21,
              device=None):
    """Refine a fundamental estimate by scanning ±span for peak magnitude."""
    signal = as_f64(signal, device)
    f0_guess = as_f64(f0_guess, signal.device)
    offsets = torch.linspace(-span_hz, span_hz, steps, dtype=torch.float64,
                             device=signal.device)
    cands = f0_guess[..., None] + offsets  # (..., steps)
    mags = dft_magnitude(signal, cands, sample_rate)
    best = torch.argmax(mags, dim=-1)
    return torch.take_along_dim(cands, best[..., None], dim=-1)[..., 0]


def harmonic_ladder(signal, f0, sample_rate, n_harmonics=12, refine=True,
                    device=None):
    """Magnitudes of H1..Hn of a (batched) note render.

    Returns (refined_f0, mags (..., n_harmonics))."""
    signal = as_f64(signal, device)
    f0 = as_f64(f0, signal.device)
    if refine:
        f0 = refine_f0(signal, f0, sample_rate)
    harmonics = f0[..., None] * torch.arange(
        1, n_harmonics + 1, dtype=torch.float64, device=signal.device)
    return f0, dft_magnitude(signal, harmonics, sample_rate)


def band_rms(signal, lo_hz, hi_hz, sample_rate, device=None):
    """RMS of the band [lo, hi] via rFFT masking (broadband HF metrics)."""
    signal = as_f64(signal, device)
    n = signal.shape[-1]
    spec = torch.fft.rfft(signal, dim=-1)
    freqs = torch.fft.rfftfreq(n, 1.0 / sample_rate, dtype=torch.float64,
                               device=signal.device)
    mask = (freqs >= lo_hz) & (freqs <= hi_hz)
    # Parseval: RMS of the band-limited signal
    power = torch.sum(torch.where(mask, torch.abs(spec) ** 2, 0.0), dim=-1)
    # rfft double-counts everything but DC/nyquist; fine for band metrics
    return exact.div(torch.sqrt(2.0 * power), float(n))
