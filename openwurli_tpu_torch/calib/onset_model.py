"""Learned onset + pitch detector for note extraction (ML stage 1).

Port of `openwurli_tpu/calib/onset_model.py`: the features, context
windows, harmonic bins and initial parameters in NumPy (copies), the
network, its loss and its training in float32 torch on a device
(`conv2d` for the reference's NHWC/HWIO convolutions, cuDNN's TF32 off),
the decoding in NumPy. A small network that learns the instrument it will
transcribe from audio rendered by this repo's synthesis path (the
reference pipeline's basic-pitch role).

Design:
  * features: log triangular filterbank (96 log-spaced bands, 40 Hz-4.2 kHz)
    over |rfft| frames (~93 ms, hop /8 — the long window resolves
    low-register semitones), standardized per-bin by trained stats;
  * model: conv trunk over the (context × log-frequency) patch — a
    (7 t × 15 bin) conv collapses the time context, a 15-bin conv mixes
    neighborhoods along log-frequency (pitch-equivariant weight sharing,
    the prior that lets one training note generalize across the
    keyboard) — then HARMONIC STACKING: for each candidate pitch, the
    trunk features at its fundamental and harmonic 2-6 bins are
    gathered and fed to ONE pitch-shared MLP head emitting per-pitch
    onset and note-presence logits (the basic-pitch structure: the head
    sees exactly the harmonic evidence pattern, every pitch shares its
    statistics, and harmonics of a sounding note do not fire their own
    rows because their own stacks lack upper partials). The per-pitch
    map form is what dense-mixture recall needs;
  * training: mixtures synthesized from fast-path single-note renders
    (random onsets/gains/polyphony + noise), per-element weighted BCE on
    both maps with AdamW under a cosine-decayed rate;
  * decoding: per-pitch peak picking on the onset map with ±1-semitone
    non-maximum suppression → the same note-dict schema as
    calib.notes.extract_notes.

Weights live in openwurli_tpu_torch/data/onset_pitch.npz, a byte copy of
the reference package's.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from openwurli_tpu_torch import DATA_DIR

N_BINS = 96
F_LO = 40.0
F_HI = 4200.0
CONTEXT = 7               # frames of context (centered)
MIDI_LO, MIDI_HI = 36, 96
N_NOTES = MIDI_HI - MIDI_LO + 1       # per-pitch map width (61)
N_PITCH = N_NOTES + 1                 # legacy constant (+ "no pitch")
C1_CH, C2_CH = 24, 32
K_BINS = 15
N_HARM = 6                            # harmonic-stack depth (h = 1..6)
HEAD_H = 64                           # pitch-shared head hidden width


def harmonic_bins():
    """(N_NOTES, N_HARM) filterbank bin index of harmonic h of each
    candidate pitch (clipped to the band edges; the head learns that
    top-of-band pitches lose upper partials)."""
    delta = (np.log(F_HI) - np.log(F_LO)) / (N_BINS + 1)
    midis = np.arange(MIDI_LO, MIDI_HI + 1)
    f0 = 440.0 * 2.0 ** ((midis - 69) / 12.0)
    h = np.arange(1, N_HARM + 1)
    freq = f0[:, None] * h[None, :]
    b = np.rint((np.log(freq) - np.log(F_LO)) / delta - 1.0)
    return np.clip(b, 0, N_BINS - 1).astype(np.int32)

_DATA = os.path.join(DATA_DIR, "onset_pitch.npz")


def frame_params(sr):
    """(frame_len, hop) ≈ 93 ms / 11.6 ms at any sample rate.

    The long window buys low-register resolution: at 44.1 kHz a 46 ms
    window's 21.5 Hz bins cannot separate semitones below ~E2, where the
    keyboard starts (MIDI 36 ≈ 65 Hz)."""
    frame = 1 << max(9, int(round(np.log2(0.093 * sr))))
    return frame, frame // 8


def _filterbank(sr, frame):
    """(N_BINS, frame//2+1) triangular log-spaced filterbank."""
    freqs = np.fft.rfftfreq(frame, 1.0 / sr)
    f_hi = min(F_HI, 0.45 * sr)
    edges = np.exp(np.linspace(np.log(F_LO), np.log(f_hi), N_BINS + 2))
    fb = np.zeros((N_BINS, len(freqs)))
    for b in range(N_BINS):
        lo, mid, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (freqs - lo) / max(mid - lo, 1e-9)
        down = (hi - freqs) / max(hi - mid, 1e-9)
        fb[b] = np.clip(np.minimum(up, down), 0.0, None)
        s = fb[b].sum()
        if s > 0:
            fb[b] /= s
    return fb


def features(audio, sr):
    """Log-filterbank frames → (n_frames, N_BINS) float32."""
    x = np.asarray(audio, dtype=np.float64)
    if x.ndim > 1:
        x = x.mean(axis=1)
    frame, hop = frame_params(sr)
    if len(x) < frame:
        x = np.pad(x, (0, frame - len(x)))
    n = 1 + (len(x) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    spec = np.abs(np.fft.rfft(x[idx] * np.hanning(frame), axis=1))
    fb = _filterbank(sr, frame)
    return np.log(spec @ fb.T + 1e-6).astype(np.float32)


def context_windows(feats):
    """(n, N_BINS) → (n, CONTEXT*N_BINS) centered context (edge-padded)."""
    half = CONTEXT // 2
    padded = np.pad(feats, ((half, half), (0, 0)), mode="edge")
    cols = [padded[i:i + len(feats)] for i in range(CONTEXT)]
    return np.concatenate(cols, axis=1)


def init_params(seed=0):
    rng = np.random.default_rng(seed)

    def glorot(shape, fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    d_stack = N_HARM * C2_CH
    return {
        # (time, bins, in_ch, out_ch) conv over the context patch
        "C1": glorot((CONTEXT, K_BINS, 1, C1_CH),
                     CONTEXT * K_BINS, K_BINS * C1_CH),
        "c1b": np.zeros(C1_CH, np.float32),
        # 1D conv along the log-frequency axis
        "C2": glorot((1, K_BINS, C1_CH, C2_CH),
                     K_BINS * C1_CH, K_BINS * C2_CH),
        "c2b": np.zeros(C2_CH, np.float32),
        # pitch-SHARED harmonic-stack head (one set of weights for all
        # 61 pitch rows)
        "H1": glorot((d_stack, HEAD_H), d_stack, HEAD_H),
        "h1b": np.zeros(HEAD_H, np.float32),
        "Ho": glorot((HEAD_H, 1), HEAD_H, 1),
        "hob": np.zeros(1, np.float32),
        "Hn": glorot((HEAD_H, 1), HEAD_H, 1),
        "hnb": np.zeros(1, np.float32),
        "feat_mean": np.zeros(N_BINS, np.float32),
        "feat_std": np.ones(N_BINS, np.float32),
        "fmt": np.asarray([3], np.int32),   # weight-format version tag
    }


def conv_precision():
    """The convolutions' settings: cuDNN without TF32 (on by default in
    PyTorch, unlike matmul's), so that the card computes them in float32
    as the reference does. Nothing global changes outside the block."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def params_to(params, device):
    """A NumPy params dict → float32 tensors on `device` (`fmt` int32)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in params.items()}


def forward(params, x):
    """x (n, CONTEXT*N_BINS) float32 tensor → (onset_logits (n, N_NOTES),
    note_logits (n, N_NOTES)) — per-(frame, midi) maps; params a dict of
    tensors on x's device."""
    n = x.shape[0]
    h = x.reshape(n, CONTEXT, N_BINS)
    h = (h - params["feat_mean"][None, None, :]) \
        / params["feat_std"][None, None, :]
    h = h[:, None]                        # NCHW: (n, 1, 7, 96)
    pad = (0, K_BINS // 2)
    with conv_precision():
        # HWIO → OIHW
        h = F.conv2d(h, params["C1"].permute(3, 2, 0, 1), padding=pad)
        h = torch.relu(h + params["c1b"][None, :, None, None])  # (n, C1, 1, 96)
        h = F.conv2d(h, params["C2"].permute(3, 2, 0, 1), padding=pad)
        h = torch.relu(h + params["c2b"][None, :, None, None])  # (n, C2, 1, 96)
    h = h.reshape(n, C2_CH, N_BINS).transpose(1, 2)   # (n, 96, C2)
    # harmonic stacking: (n, N_NOTES, N_HARM, C2) gather of each pitch
    # row's fundamental + harmonic bins, then the pitch-shared head
    hb = torch.from_numpy(harmonic_bins().astype(np.int64)).to(x.device)
    g = h[:, hb, :].reshape(n, N_NOTES, N_HARM * C2_CH)
    z = torch.relu(g @ params["H1"] + params["h1b"])
    onset = (z @ params["Ho"] + params["hob"])[..., 0]   # (n, N_NOTES)
    note = (z @ params["Hn"] + params["hnb"])[..., 0]
    return onset, note


def loss_fn(params, x, y_onset, y_note, note_mask=None,
            onset_pos_weight=400.0, note_pos_weight=8.0):
    """Per-element weighted BCE on both maps.

    y_onset/y_note: (n, N_NOTES) {0,1}; note_mask (n, N_NOTES) weights
    the note-map loss (0 masks ambiguous ring-out frames)."""
    ol, nl = forward(params, x)

    def bce(z, y, pos_w):
        z = torch.clamp(z, -30.0, 30.0)
        raw = torch.relu(z) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
        return raw * (1.0 + (pos_w - 1.0) * y)

    onset_loss = torch.mean(bce(ol, y_onset, onset_pos_weight))
    nm = bce(nl, y_note, note_pos_weight)
    if note_mask is not None:
        note_loss = torch.sum(nm * note_mask) \
            / torch.clamp(torch.sum(note_mask), min=1.0)
    else:
        note_loss = torch.mean(nm)
    return onset_loss + 0.5 * note_loss


def cosine_decay(lr, steps, alpha=0.01):
    """optax.cosine_decay_schedule(lr, steps, alpha) as a LambdaLR factor
    of the step count (count 0 → 1)."""
    def factor(count):
        c = min(count, steps)
        return (1.0 - alpha) * 0.5 * (1.0 + np.cos(np.pi * c / steps)) \
            + alpha
    return factor


def train(x, y_onset, y_note, note_mask=None, steps=3000, batch=512,
          lr=2e-3, seed=0, log_every=0, weight_decay=1e-4,
          input_noise=0.15, device="cuda"):
    """Train on precomputed frames (NumPy) on `device`; returns a NumPy
    params dict.

    weight_decay (AdamW) and input_noise (gaussian jitter on the raw
    log-filterbank features, in log-energy units) close most of the
    train≪val generalization gap. Batches and noise are drawn from
    `np.random.default_rng(seed)` in the reference's order."""
    params = init_params(seed)
    # Per-bin standardization (x rows are CONTEXT stacked frames). The
    # std is FLOORED at 0.25: bins that are near-constant in training
    # (e.g. sub-audio bands holding only the log-epsilon floor) would
    # otherwise turn any out-of-distribution energy into standardized
    # values in the thousands and saturate the heads.
    per_bin = x.reshape(-1, CONTEXT, N_BINS)[:, CONTEXT // 2, :]
    params["feat_mean"] = per_bin.mean(axis=0).astype(np.float32)
    params["feat_std"] = np.maximum(per_bin.std(axis=0),
                                    0.25).astype(np.float32)
    train_keys = [k for k in params
                  if not k.startswith("feat_") and k != "fmt"]

    pt = params_to(params, device)
    for k in train_keys:
        pt[k].requires_grad_(True)
    opt = torch.optim.AdamW([pt[k] for k in train_keys], lr=lr,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(lr, steps))

    if note_mask is None:
        note_mask = np.ones_like(y_note, dtype=np.float32)

    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(device)
    y_onset = torch.from_numpy(y_onset.astype(np.float32)).to(device)
    y_note = torch.from_numpy(y_note.astype(np.float32)).to(device)
    note_mask = torch.from_numpy(note_mask.astype(np.float32)).to(device)
    n = xt.shape[0]
    for s in range(steps):
        sel = rng.integers(0, n, size=min(batch, n))
        idx = torch.from_numpy(sel).to(device)
        xb = xt[idx]
        if input_noise:
            xb = xb + torch.from_numpy(
                rng.normal(0.0, input_noise,
                           size=(len(sel), xt.shape[1])).astype(
                               np.float32)).to(device)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(pt, xb, y_onset[idx], y_note[idx], note_mask[idx])
        loss.backward()
        opt.step()
        sched.step()
        if log_every and s % log_every == 0:
            print(f"step {s}: loss {float(loss):.4f}", flush=True)
    return {k: v.detach().cpu().numpy() for k, v in pt.items()}


def save_params(params, path=_DATA):
    np.savez_compressed(path, **params)


def load_params(path=_DATA):
    """Returns the trained weight dict, or None when absent/incompatible
    (weight files without the fmt == 3 tag are treated as absent, so that
    extraction falls back to the spectral path instead of crashing)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "fmt" not in z.files or int(z["fmt"][0]) != 3:
            return None
        return {k: z[k] for k in z.files}


def predict(params, audio, sr, device="cuda"):
    """(onset_prob (n, N_NOTES), note_prob (n, N_NOTES), hop_s), NumPy;
    the network runs on `device`."""
    feats = features(audio, sr)
    xs = context_windows(feats)
    with torch.inference_mode():
        ol, nl = forward(params_to(params, device),
                         torch.from_numpy(xs).to(device))
        frame, hop = frame_params(sr)
        return (torch.sigmoid(ol).cpu().numpy(),
                torch.sigmoid(nl).cpu().numpy(), hop / sr)


def nn_extract_notes(audio, sr, params=None, min_duration=0.25,
                     onset_threshold=0.5, min_gap_s=0.15,
                     note_span_s=0.5, device="cuda"):
    """Model-based drop-in for calib.notes.extract_notes.

    Decodes the per-pitch onset map: a note fires where a pitch row has
    a local-in-time posterior peak ≥ threshold that also dominates its
    ±1-semitone neighbors there (non-maximum suppression along pitch —
    the conv trunk's pitch equivariance makes neighbor rows co-fire).
    min_gap_s applies PER PITCH ROW, so simultaneous onsets of
    different notes decode independently. Pitch confirmation reads the note-presence
    map over [onset, onset+note_span_s]. Returns the same note-dict
    schema (onset_s/offset_s/midi_note/f0_hz/velocity_norm); empty list
    when no trained weights are available. The network runs on `device`.
    """
    params = params if params is not None else load_params()
    if params is None:
        return []
    audio = np.asarray(audio, dtype=np.float64)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    prob, note_prob, hop_s = predict(params, audio, sr, device)
    n = prob.shape[0]
    min_gap = max(1, int(min_gap_s / hop_s))
    span = max(1, int(note_span_s / hop_s))

    cands = []
    for p in range(N_NOTES):
        row = prob[:, p]
        last = -10 * min_gap
        for i in range(1, n - 1):
            if (row[i] >= onset_threshold and row[i] >= row[i - 1]
                    and row[i] > row[i + 1] and i - last >= min_gap):
                # ±1-semitone NMS: the true row's peak dominates
                lo, hi = max(p - 1, 0), min(p + 2, N_NOTES)
                w0, w1 = max(i - 2, 0), min(i + 3, n)
                if row[i] + 1e-6 < prob[w0:w1, lo:hi].max():
                    continue
                last = i
                cands.append((i, p, float(row[i])))
    cands.sort()

    notes = []
    peak_global = max(np.abs(audio).max(), 1e-12)
    # per-pitch next-onset boundaries for offsets
    next_onset = {}
    for i, p, _ in reversed(cands):
        off_frame = next_onset.get(p, n)
        next_onset[p] = i
        onset_s = i * hop_s
        offset_s = min(off_frame * hop_s, len(audio) / sr)
        if offset_s - onset_s < min_duration:
            continue
        # note-presence confirmation over the early sustain
        b = min(i + span, off_frame, n)
        conf = float(note_prob[i:b, p].mean()) if b > i else 0.0
        if conf < 0.2:
            continue
        midi = MIDI_LO + p
        f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0)
        seg = audio[int(onset_s * sr): int(offset_s * sr)]
        vel = float(np.abs(seg[: int(0.05 * sr)]).max()
                    / peak_global) if len(seg) else 0.0
        notes.append({
            "onset_s": float(onset_s),
            "offset_s": float(offset_s),
            "midi_note": midi,
            "f0_hz": float(f0),
            "velocity_norm": min(vel, 1.0),
        })
    notes.sort(key=lambda d: d["onset_s"])
    return notes
