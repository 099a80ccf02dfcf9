"""Bit-exact integer PRNGs: the reed-jitter / attack-noise LCG and the
Box-Muller note-on draws. Port of `openwurli_tpu/prng.py`: uint32 NumPy at
note-on, int64 torch tensors holding u32 words in the per-sample steps."""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact

_U32 = np.uint32
LCG_MUL = 1664525
LCG_ADD = 1013904223
_HALF_U32_MAX = 4294967295.0 / 2.0
TAU = 6.283185307179586


def lcg_next(state):
    """state' = state * 1664525 + 1013904223 (mod 2^32)."""
    with np.errstate(over="ignore"):
        return (np.asarray(np.asarray(state).astype(_U32)) * _U32(LCG_MUL)
                + _U32(LCG_ADD))


def lcg_to_unit(state):
    """(state >> 1) / (u32::MAX / 2) ∈ [0, 1)."""
    return (np.asarray(state) >> _U32(1)).astype(np.float64) / _HALF_U32_MAX


def box_muller_draws(seed, n):
    """n standard-normal draws from two LCG steps each.

    seed: uint32 array. Returns (final_state, draws[..., n])."""
    state = np.maximum(np.asarray(np.asarray(seed).astype(_U32)), _U32(1))
    draws = []
    for _ in range(n):
        state = lcg_next(state)
        u1 = lcg_to_unit(state)
        state = lcg_next(state)
        u2 = lcg_to_unit(state)
        r = np.sqrt(-2.0 * np.log(np.maximum(u1, 1e-30)))
        draws.append(r * np.cos(TAU * u2))
    return state, np.stack(draws, axis=-1)


# ── torch step draws: u32 words carried in int64, masked to 32 bits ──

U32_MASK = 0xFFFFFFFF
SQRT_3 = 1.7320508080  # the reference truncates at this precision


def lcg_next_i64(state):
    """One LCG step on int64 tensors holding u32 words (no overflow: the
    product is below 2^53)."""
    return (state * LCG_MUL + LCG_ADD) & U32_MASK


def lcg_uniform_scaled(state):
    """(new_state, noise): uniform(-√3, √3), unit variance (reed jitter)."""
    s = lcg_next_i64(state)
    u = exact.div((s >> 1).to(torch.float64), _HALF_U32_MAX)
    return s, (u * 2.0 - 1.0) * SQRT_3


def lcg_signed_unit(state):
    """(new_state, noise): the word as i32 / i32::MAX ∈ (-1, 1] (hammer
    attack noise)."""
    s = lcg_next_i64(state)
    signed = torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.float64)
    return s, exact.div(signed, 2147483647.0)


# ── the melange preamp's thermal-noise stream: JAX's threefry2x32 key
# schedule (`jax.random.PRNGKey`, `split`, `key_data`) and its float64
# `jax.random.normal`, with jax_threefry_partitionable on. Key words are
# u32 values carried in int64 tensors of shape (..., 2). ──

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)` as NumPy int64 words [seed >> 32,
    seed & 0xFFFFFFFF]."""
    seed = int(seed)
    return np.array([(seed >> 32) & U32_MASK, seed & U32_MASK], np.int64)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & U32_MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pair (x1, x2) under
    the key (k1, k2); int64 tensors of u32 words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & U32_MASK, (x2 + ks[1]) & U32_MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & U32_MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & U32_MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & U32_MASK
    return x[0], x[1]


def split(key):
    """`jax.random.split(key)` → (new_key, sub), each (..., 2): the hash of
    the counts (0, 0) and (0, 1)."""
    k1, k2 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k1)
    new = threefry2x32(k1, k2, zero, zero)
    sub = threefry2x32(k1, k2, zero, zero + 1)
    return torch.stack(new, dim=-1), torch.stack(sub, dim=-1)


# XLA's float64 erf_inv (Giles' single-precision-style polynomial in
# w = −log1p(−x²), three ranges of w), as `jax.scipy.special.erfinv`
# compiles it: coefficients from the highest power down.
ERFINV_LT_6_25 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027)
ERFINV_LT_16 = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
    -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
    3.0838856104922208)
ERFINV_GT_16 = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.849906401408584)


def erfinv(x):
    """XLA's float64 erf_inv on a float64 tensor, operation for operation
    (csrc/engine.cu writes it the same way): −log1p(−x·x), the range
    selects, the Horner steps, ±inf at |x| = 1."""
    w = -torch.log1p(x * -x)
    lt625 = w < 6.25
    lt16 = w < 16.0
    sqrt_w = torch.sqrt(w)
    t = torch.where(lt625, w + -3.125,
                    sqrt_w - torch.where(lt16, 3.25, torch.full_like(w, 5.0)))

    def coef(i):
        c = torch.full_like(w, ERFINV_LT_6_25[i])
        if i < 19:
            c = torch.where(lt625, c, ERFINV_LT_16[i])
        if i < 17:
            c = torch.where(lt16, c, ERFINV_GT_16[i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * t
    for i in range(17, 19):
        p = torch.where(lt16, coef(i) + p * t, p)
    for i in range(19, 23):
        p = torch.where(lt625, p * t + ERFINV_LT_6_25[i], p)
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


NORMAL_LO = float(np.nextafter(-1.0, 0.0))
SQRT_2 = float(np.sqrt(2.0))


def normal_f64(key, n: int):
    """`jax.random.normal(key, (..., n), float64)` for keys (..., 2): 64
    random bits per draw (the hash of the counts (0, i)), their top 52
    bits as a uniform in [0, 1), scaled to [nextafter(−1, 0), 1), then
    √2 · erfinv."""
    k1, k2 = key[..., 0, None], key[..., 1, None]
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    mant = (b1 << 20) | (b2 >> 12)                 # bits64 >> 12, < 2^52
    floats = mant.to(torch.float64) * 2.0 ** -52   # exact
    u = exact.maximum(floats * (1.0 - NORMAL_LO) + NORMAL_LO, NORMAL_LO)
    return SQRT_2 * erfinv(u)
