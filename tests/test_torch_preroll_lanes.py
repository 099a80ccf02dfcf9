"""Properties of the tremolo update that the warp K4 (`trem_preroll_kernel`
in `csrc/mono_chain.cu`) relies on, checked on the plain torch version and
on the JAX package's `trem_update`:

  (a) the LDR rows (`gldr_cur`, `gldr_upd_prev`) are write-only: an update
      never reads them, it moves `gldr_cur` into `gldr_upd_prev` and writes
      a new `gldr_cur`. So K4 computes the LDR tail only in the last two
      updates of a capture interval;
  (b) the plain pre-roll at one and at two updates per interval equals the
      serial update loop, `gldr_upd_prev` included where it crosses an
      interval (the case the skipped tail relies on most);
  (c) one capture runs no update;
  (d) from a state with the tremolo's node voltages at 0, the first
      updates take pnjlim's limited branch on some rows and not on others:
      the state the card checks use to reach K4's warp-wide branch.

A few updates each: seconds on one core.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.kernels import mono_chain as jmc
from openwurli_tpu_torch.kernels import mono_chain as mc

torch.set_num_threads(1)

SR = 44100.0
LDR = ("gldr_cur", "gldr_upd_prev")


def _port_update():
    consts = mc.pack_consts(SR)
    ctrl = mc.make_controls(SR, 1, depth=0.7, character=1.0)
    c, sc = mc.chain_tensors(consts, ctrl), mc.scalar_tensors(consts)
    full = mc.unpack_state(mc.init_state(SR, 1))
    st = {n: full[n].clone() for n in mc.TREM_STATE}
    return (lambda s: mc.trem_update(c, sc, s)), st, \
        (lambda x: x.numpy().view(np.int32))


def _jax_update():
    consts = jmc.pack_consts(SR)
    ctrl = jmc.make_controls(SR, 1, depth=0.7, character=1.0)
    c, sc = jmc._merged_consts(consts, jnp.asarray(ctrl))
    full = jmc.unpack_state(jnp.asarray(jmc.init_state(SR, 1)))
    st = {n: full[n] for n in jmc.TREM_STATE}
    return (lambda s: jmc.trem_update(c, sc, s)), st, \
        (lambda x: np.asarray(x, np.float32).view(np.int32))


def _with_nan(st):
    out = dict(st)
    for n in LDR:
        out[n] = st[n] * float("nan")
    return out


@pytest.mark.parametrize("side", ["port", "jax"])
def test_ldr_rows_are_write_only(side):
    update, st, bits = (_port_update if side == "port" else _jax_update)()
    st = update(update(st))  # a state away from the initial one
    clean, dirty = update(st), update(_with_nan(st))
    for n in mc.TREM_STATE:
        if n != "gldr_upd_prev":
            np.testing.assert_array_equal(bits(dirty[n]), bits(clean[n]), n)
    assert np.isnan(np.asarray(dirty["gldr_upd_prev"])).all()
    clean, dirty = update(clean), update(dirty)
    for n in mc.TREM_STATE:
        np.testing.assert_array_equal(bits(dirty[n]), bits(clean[n]), n)
        assert np.isfinite(np.asarray(clean[n])).all(), n


@pytest.mark.parametrize("stride", [mc.SUB_BASE, 2 * mc.SUB_BASE])
def test_preroll_equals_serial_loop_at_short_strides(stride):
    update, st, _ = _port_update()
    ctrl = mc.make_controls(SR, 1, depth=0.7, character=1.0)
    caps = mc.trem_preroll_plain(mc.pack_consts(SR), ctrl,
                                 mc.init_state(SR, 1), 5, stride)
    for k in range(5):
        ref = torch.cat([st[n][:, 0] for n in mc.TREM_STATE])
        assert torch.equal(caps[k].view(torch.int32), ref.view(torch.int32))
        for _ in range(stride // mc.SUB_BASE):
            st = update(st)
    # the LDR rows move: each capture's gldr_upd_prev is the gldr_cur of
    # the update before the last one, across intervals when it is the
    # interval's only update
    col = {n: ca for n, _a, _b, ca, _cb in mc.preroll_rows()}
    cur, prev = caps[:, col["gldr_cur"]], caps[:, col["gldr_upd_prev"]]
    if stride == mc.SUB_BASE:
        assert torch.equal(prev[1:], cur[:-1])
    assert not torch.equal(cur[1:], cur[:-1])


@pytest.mark.parametrize("stride", [mc.SUB_BASE, 64])
def test_one_capture_runs_no_update(stride, monkeypatch):
    def no_update(*_a, **_k):
        raise AssertionError("an update ran after the last capture")

    monkeypatch.setattr(mc, "trem_update", no_update)
    ctrl = mc.make_controls(SR, 1, depth=0.5)
    state = mc.init_state(SR, 1)
    rows, caps = mc.trem_preroll(SR, ctrl, 1, stride, state_flat=state)
    assert caps.shape == (1, mc.PREROLL_ROWS)
    ref = torch.cat([state[a:b, 0] for _n, a, b, _ca, _cb in rows])
    assert torch.equal(caps[0], ref)


def test_zero_node_voltages_take_the_limited_branch(monkeypatch):
    takes = []
    pnjlim = mc._pnjlim

    def recording(v_old, v_new, nvt, vcrit):
        takes.append(((v_new > vcrit) & (v_new - v_old > 2.0 * nvt))[:, 0])
        return pnjlim(v_old, v_new, nvt, vcrit)

    monkeypatch.setattr(mc, "_pnjlim", recording)
    state = mc.init_state(SR, 1)
    state[slice(*mc._OFFSETS["trem_vnl"])] = 0.0
    ctrl = mc.make_controls(SR, 1, depth=0.7)
    caps = mc.trem_preroll_plain(mc.pack_consts(SR), ctrl, state, 2, 8)
    rows = torch.stack(takes)
    assert rows.shape == (4 * mc.N_TREM_ITERS, 4)
    assert 0 < int(rows.any(1).sum()) and not rows.all(1).any()
    assert torch.isfinite(caps).all()
