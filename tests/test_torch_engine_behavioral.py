"""The f64 engine with the behavioral power amp in the PyTorch port
(`Engine(44100, pa_model="behavioral")`, its kernels' plain versions on
the CPU) against the JAX `Engine` with the same model: the session of
tests/test_torch_engine_melange.py without its noise. Target: output
within -120 dB RMS of the reference's; slot states, NaN-guard fires and
the (unstepped) power-amp counters equal."""

import torch

from test_torch_engine_melange import check_engine

torch.set_num_threads(1)


def test_behavioral_engine_matches_reference():
    port, _ = check_engine(("dk", "behavioral"), noise=False)
    assert port.params.pa_model == "behavioral"
    assert all(v == 0 for v in port.power_amp_diag().values())
