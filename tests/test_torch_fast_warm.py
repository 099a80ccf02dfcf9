"""The PyTorch port's `fast.render_grid` with a 1024-sample silent warm-up
of the chain (the `warm_seconds` call through K2), against the JAX
composition. Gates and measured levels: see `test_torch_fast.py`; a file of
its own so that each CPU render fits one test file's time budget. The
render after the warm-up is 256 samples, with t_tile=256 so that neither
the warm-up nor the render is padded past its length."""

import torch

from test_torch_fast import check_render_grid, reference_case

torch.set_num_threads(1)

WARM = 1024
T_WARM_CASE = 256


def test_render_grid_matches_jax_composition_warm(monkeypatch):
    check_render_grid(monkeypatch, WARM, *reference_case(WARM, T_WARM_CASE),
                      t_tile=T_WARM_CASE)
