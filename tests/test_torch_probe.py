"""The probe kernel's plain bodies (`kernels/probe.py`, P1) on the CPU,
each against a NumPy float32 loop written here, over a handful of
iterations. `tools/tpu_probe.py` runs only on a TPU, so it is the
specification of the bodies and not the oracle: the loops below are read
off its bodies, one lane at a time where the body couples rows.

Tolerance: bit for bit, except `expchain` (torch's and NumPy's float32 exp
may differ in the last place: 2 ulp).
"""

import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import probe

torch.set_num_threads(1)

F = np.float32
X0 = 0.37
ITERS = 5


def bits(x):
    return np.ascontiguousarray(x).view(np.int32)


def run(body, sub, lan, depth=0, mat=None, iters=ITERS):
    before = probe.PLAIN_CALLS, probe.KERNEL_LAUNCHES
    out, aux = probe.run_probe(body, iters, sub, lan, depth, x0=X0, mat=mat,
                               device="cpu")
    assert (probe.PLAIN_CALLS, probe.KERNEL_LAUNCHES) == \
        (before[0] + 1, before[1])
    assert out.shape == (1, 128) and out.dtype == torch.float32
    return out.numpy(), None if aux is None else aux.numpy()


def test_empty():
    out, aux = run("empty", 8, 128)
    assert (out == F(X0)).all()
    assert aux.shape == (1, 128) and (aux == F(ITERS)).all()


@pytest.mark.parametrize("sub,lan,depth", [(8, 128, 20), (64, 256, 3)])
def test_chain(sub, lan, depth):
    out, aux = run("chain", sub, lan, depth)
    v = F(X0)
    for _ in range(ITERS * depth):
        v = F(F(v * F(1.0000001)) + F(0.0000001))
    assert aux is None
    assert np.array_equal(bits(out), bits(np.full((1, 128), v, F)))


def test_expchain():
    out, _ = run("expchain", 16, 128, 20)
    v = F(X0)
    for _ in range(ITERS * 20):
        v = np.exp(F(v * F(1e-6)), dtype=F)
    ulps = np.abs(bits(out).astype(np.int64)
                  - bits(np.full((1, 128), v, F)).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()


@pytest.mark.parametrize("m", [8, 32])
def test_dotchain(m):
    rng = np.random.default_rng(m)
    mat = (0.999 * np.eye(m) + 0.01 * rng.standard_normal((m, m))).astype(F)
    out, _ = run("dotchain", m, 128, 3, mat=mat)
    v = np.full(m, X0, F)
    for _ in range(ITERS * 3):
        nv = np.empty(m, F)
        for r in range(m):
            acc = F(mat[r, 0] * v[0])
            for k in range(1, m):
                acc = F(acc + F(mat[r, k] * v[k]))
            nv[r] = acc
        v = nv
    assert np.array_equal(bits(out), bits(np.full((1, 128), v[0], F)))
    # the probes' own matrix
    assert np.array_equal(probe.PROBES["dot8_8x128"][5],
                          np.eye(8, dtype=F) * F(0.999))


def _ge_rows(a, iters):
    a = a.copy()
    for _ in range(iters):
        a = (a + F(0.0)).astype(F)
        for k in range(16):
            inv = F(F(1.0) / F(a[k, k] + F(1.0)))
            a[k] = (a[k] * inv).astype(F)
            for r in range(k + 1, 16):
                f = a[r, k]
                a[r] = (a[r] - (f * a[k]).astype(F)).astype(F)
    return a


def _ge_flat(a, iters):
    a = a.copy()
    for _ in range(iters):
        a = (a + F(0.0)).astype(F)
        for k in range(16):
            inv = F(F(1.0) / F(a[k, k] + F(1.0)))
            rk = (a[k] * inv).astype(F)
            factors = a[:, k].copy()
            mask = (np.arange(16) > k).astype(F)
            a = (a - ((mask * factors).astype(F)[:, None]
                      * rk[None]).astype(F)).astype(F)
    return a


def test_ge16_rows():
    out, aux = run("ge16", 16 * 17, 128, iters=3)
    want = _ge_rows(np.full((16, 17), X0, F), 3)
    assert aux.shape == (16 * 17, 128)
    assert np.array_equal(bits(aux), bits(np.repeat(
        want.reshape(-1, 1), 128, axis=1)))
    assert np.array_equal(bits(out), bits(np.full((1, 128), want[0, 0], F)))


def test_ge16_flat_differs_from_rows():
    out, aux = run("ge16_flat", 16, 17 * 128, iters=3)
    want = _ge_flat(np.full((16, 17), X0, F), 3)
    assert aux.shape == (16, 17 * 128)
    # column j of the system holds lanes j·128..(j+1)·128
    assert np.array_equal(bits(aux), bits(np.repeat(want, 128, axis=1)))
    assert np.array_equal(bits(out), bits(np.full((1, 128), want[0, 0], F)))
    rows = _ge_rows(np.full((16, 17), X0, F), 3)
    assert not np.array_equal(rows, want)   # row k is not normalised here
    assert want[0, 0] == F(X0)


def test_dynstore():
    out, aux = run("dynstore", 8, 128, iters=11)
    v, buf = F(X0), np.full(8, X0, F)
    for i in range(11):
        v = F(v * F(1.0000001))
        buf[i % 8] = v
    assert np.array_equal(bits(out), bits(np.full((1, 128), v, F)))
    assert np.array_equal(bits(aux), bits(np.repeat(buf[:, None], 128, 1)))


def test_probe_list_is_the_reference_tool_s():
    sizes = {name: spec[2:5] for name, spec in probe.PROBES.items()}
    assert sizes == {
        "loop": (8, 128, 0), "chain20_8x128": (8, 128, 20),
        "chain20_8x1024": (8, 1024, 20), "chain20_64x128": (64, 128, 20),
        "chain20_128x1024": (128, 1024, 20), "chain100_8x128": (8, 128, 100),
        "exp20_8x128": (8, 128, 20), "exp20_16x128": (16, 128, 20),
        "dot8_8x128": (8, 128, 10), "dot32_32x128": (32, 128, 10),
        "dot32_32x1024": (32, 1024, 10), "ge16_128": (272, 128, 0),
        "ge16_1024": (272, 1024, 0), "ge16f_128": (16, 17 * 128, 0),
        "dynstore": (8, 128, 0)}
    for name, (_l, body, sub, lan, depth, mat, _it) in probe.PROBES.items():
        out, _ = probe.run_probe(body, 1, sub, lan, depth, mat=mat,
                                 device="cpu")
        assert torch.isfinite(out).all(), name


def test_bad_shapes_and_devices_raise():
    with pytest.raises(ValueError, match="unknown probe"):
        probe.run_probe("fft", 1, 8, 128, device="cpu")
    with pytest.raises(ValueError):
        probe.run_probe("chain", 1, 12, 128, 1, device="cpu")
    with pytest.raises(ValueError):
        probe.run_probe("chain", 1, 8, 64, 1, device="cpu")
    with pytest.raises(ValueError):
        probe.run_probe("dotchain", 1, 8, 128, 1, device="cpu")
    with pytest.raises(ValueError):
        probe.run_probe("ge16", 1, 16, 128, device="cpu")
    with pytest.raises(ValueError):
        probe.run_probe("ge16_flat", 1, 16, 128, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        probe.run_probe("empty", 1, 8, 128, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            probe.run_probe("empty", 1, 8, 128)      # the card by default
