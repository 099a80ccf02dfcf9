"""The port's CUDA kernels against their plain torch versions on the card.

Marked `gpu`: each test skips (with its reason) where torch sees no CUDA
device, as in CPU-only test runs. On a machine with a card (without jax,
which tests/conftest.py imports, add --noconftest):
    python -m pytest tests/test_torch_cuda.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb

SR = 44100.0
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def test_voice_bank_kernel_matches_plain(cuda):
    notes = np.repeat(np.arange(36, 68), 4).astype(np.float64)
    vels = np.tile([0.3, 0.6, 0.8, 0.95], 32)
    params, n = vb.make_kernel_params(notes, vels, SR, lanes=256,
                                      device=cuda)
    steady = vb.steady_limits(params)
    out, st = vb.render_voice_bank(params, 1024, steady=steady,
                                   return_state=True)
    ref, ref_st = vb.render_voice_bank_plain(params, 1024, steady=steady,
                                             return_state=True)
    peak = ref[:, :n].abs().amax(0)
    err = (out - ref)[:, :n].abs().amax(0)
    assert (20 * torch.log10(err.clamp(min=1e-30) / peak) <= -80.0).all()
    assert torch.equal(st[40:48].view(torch.int32),
                       ref_st[40:48].view(torch.int32))
    assert out[:, n:].abs().max().item() == 0.0


def test_mono_chain_kernel_matches_plain(cuda):
    s, t = 4, 256
    audio = torch.from_numpy(
        (0.05 * np.sin(np.arange(t) / 10.0)[:, None]
         * np.linspace(0.5, 1.5, s)[None]).astype(np.float32)).to(cuda)
    ctrl = mc.make_controls(SR, s, depth=np.linspace(0, 1, s),
                            character=np.array([0.0, 1.0, 0.0, 1.0]),
                            device=cuda)
    st0 = mc.init_state(SR, s, device=cuda)
    out, st = mc.render(SR, ctrl, st0, audio)
    ref, ref_st = mc.render_chain_plain(mc.pack_consts(SR), ctrl, st0,
                                        audio)
    assert torch.equal(out, ref)
    # bit patterns: the nz_lcg rows hold u32 words, some NaN as floats
    assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))
