"""The tremolo settle scan of the PyTorch port (its plain E3 loop) against
the JAX package's `settled_osc_state`, and the spread that gates the
card's full settle.

  * At an uncached rate (64 kHz) with SETTLE_SECONDS cut to 0.02 s in both
    packages, the port's plain settle matches the reference's scan within
    1e-9 of the node swing (max |v|).
  * The reference's own full 2 s settle at 88.2 kHz, from its perturbed
    start and from that start moved by one ulp, against the package data
    (data/tremolo_settled.npz): the larger difference, doubled, is
    `chip_smoke.E3_SETTLE_GATE`, the gate of the card's settle there.
  * `mono_chain.pack_consts` builds at a 32 kHz base rate on the CPU.

Every cache that holds a short settle is cleared afterwards.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.circuits import mna as jmna
from openwurli_tpu.circuits import tremolo as jtrem
from openwurli_tpu_torch.circuits import tremolo
from openwurli_tpu_torch.kernels import engine as ek
from openwurli_tpu_torch.kernels import mono_chain as pmc

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

SHORT_S = 0.02


def _clear():
    jtrem.settled_osc_state.cache_clear()
    tremolo._settled.cache_clear()
    pmc.pack_consts.cache_clear()
    pmc._kernel_inputs.cache_clear()
    ek.chain_params.cache_clear()


@pytest.fixture
def short_settle(monkeypatch):
    _clear()
    monkeypatch.setattr(jtrem, "SETTLE_SECONDS", SHORT_S)
    monkeypatch.setattr(tremolo, "SETTLE_SECONDS", SHORT_S)
    yield
    _clear()


def test_plain_settle_matches_reference_at_uncached_rate(short_settle):
    sr = 64000.0
    ref = jax.tree.map(np.asarray, jtrem.settled_osc_state(sr))
    port = tremolo.settled_osc_state(sr, "cpu")
    swing = np.abs(ref.v).max()
    for name in ("v", "i_nl", "v_nl"):
        a, b = getattr(port, name), getattr(ref, name)
        err = np.abs(a - b).max()
        scale = swing if name != "i_nl" else np.abs(b).max()
        print(f"{name}: {err:.3g} of {scale:.3g}")
        assert err <= 1e-9 * scale, name
    # the settle moved the state well away from its perturbed start
    start = tremolo.perturbed_start(tremolo.make_params(sr))
    assert np.abs(port.v - start.v.numpy()).max() > 1e-5
    # the npz stays the first source: a cached rate is read, not settled
    calls = ek.SETTLE_PLAIN_CALLS
    z = tremolo.settled_osc_state(88200.0, "cpu")
    assert ek.SETTLE_PLAIN_CALLS == calls
    with np.load(tremolo.SETTLED_PATH) as d:
        assert np.array_equal(z.v, d["sr88200_v"])


def test_reference_full_settle_spread_against_npz():
    """The reference's 2 s settle at 88.2 kHz, unperturbed and from a
    1-ulp-moved start, against the npz: doubled, the larger difference is
    chip_smoke's gate for E3's full settle."""
    _clear()
    sr = 88200.0
    params = jtrem.make_params(sr)
    step = jtrem._osc_step_fn(sr)
    w0 = jnp.zeros_like(params.solver.w)

    @jax.jit
    def settle(osc):
        def body(st, _):
            return step(st, w0)[0], None

        return jax.lax.scan(body, osc, None,
                            length=int(sr * jtrem.SETTLE_SECONDS))[0]

    osc = jmna.init_state(params.solver)
    osc = osc._replace(v=osc.v.at[params.out_idx].add(1e-3))
    moved = osc._replace(v=jnp.asarray(np.nextafter(np.asarray(osc.v),
                                                    np.inf)))
    with np.load(tremolo.SETTLED_PATH) as z:
        npz = {k: z[f"sr88200_{k}"] for k in ("v", "vnl")}
    spread = 0.0
    for start in (osc, moved):
        st = settle(start)
        d = max(np.abs(np.asarray(st.v) - npz["v"]).max(),
                np.abs(np.asarray(st.v_nl) - npz["vnl"]).max())
        print(f"reference settle vs npz: {d:.3g} V")
        spread = max(spread, d)
    # measured 1.99e-7 V (unperturbed) and 8.2e-8 V (1 ulp) on an x86-64
    # CPU; chip_smoke gates at twice the larger
    assert 0.0 < spread <= chip_smoke.E3_SETTLE_GATE / 2


def test_pack_consts_builds_at_a_newly_settled_rate(short_settle):
    calls = ek.SETTLE_PLAIN_CALLS
    consts = pmc.pack_consts(32000.0, "cpu")
    assert ek.SETTLE_PLAIN_CALLS == calls + 1  # 64 kHz, settled on the CPU
    assert all(np.all(np.isfinite(a)) for a in consts.arrays.values())
    st = pmc.init_state(32000.0, 1, device="cpu")
    assert torch.isfinite(st).all()
    assert ek.SETTLE_PLAIN_CALLS == calls + 1  # cached per rate and device
