"""Multi-device dry run: `python -m openwurli_tpu_torch.parallel.dryrun N
[--device cpu]`. Port of `openwurli_tpu/parallel/dryrun.py`.

Checks the data-parallel story (notes are independent; a training step's
reductions are the only communication) over N ranks of one process group:

  * the ranks: N NCCL processes on cuda:0 … cuda:N-1, or with
    `--device cpu` N gloo processes on the CPU (the reference forces an
    N-device virtual CPU mesh); the rendezvous is a file store in a temporary
    directory, so that concurrent runs never share a port;
  * phase 1, one full training step over the mesh: each rank renders its
    block of the note grid (`voice.render`, kernel E4 on the card), takes
    its harmonic ladder (`calib.goertzel`), the residual targets and the
    masked-Huber loss's numerator and denominator with the numerator's
    gradient; the three are summed over the ranks (`all_reduce`), so that
    the loss is sum / max(count, 1) of the whole batch, as one process
    computes it; then one SGD update (lr 1e-3) of every weight field. Gate:
    the same step in one process on rank 0's device, on the whole grid,
    within 1e-12 (loss and weights), and every rank holding the same
    weights;
  * phase 2, the fused kernels: `fast.render_grid_sharded` over 16 voices
    per stream and one `mono_chain.T_TILE` of samples, one stream per rank
    (K1, the lane sum, K2). Gate: bit for bit the standalone `render_grid`
    of each rank's stream.

Each phase prints the reference's "— OK" line from rank 0. A rank that
raises makes the run raise (and the command exit non-zero).
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from openwurli_tpu_torch import mlp, prng

SR = 8000.0
PER_RANK = 2
N_SAMPLES = 400
LEARNING_RATE = 1e-3
HIDDEN = 16
N_OUTPUTS = 11
STEP_GATE = 1e-12


def init_weights(seed=0):
    """The JAX package's `calib.train.init_weights(PRNGKey(seed))` as
    float64 NumPy MlpWeights: its threefry key split and float64 normals
    through `prng` (within a few ulps of `jax.random.normal`), Glorot
    scale sqrt(2 / fan), zero biases, means 0 and stds 1."""
    key = torch.from_numpy(prng.prng_key(seed))
    zero = torch.zeros((), dtype=torch.int64)
    subs = [torch.stack(prng.threefry2x32(key[0], key[1], zero, zero + i))
            for i in range(3)]

    def glorot(k, shape):
        z = prng.normal_f64(k, shape[0] * shape[1]).reshape(shape).numpy()
        return z * math.sqrt(2.0 / (shape[0] + shape[1]))

    return mlp.MlpWeights(
        w1=glorot(subs[0], (HIDDEN, 2)), b1=np.zeros(HIDDEN),
        w2=glorot(subs[1], (HIDDEN, HIDDEN)), b2=np.zeros(HIDDEN),
        w3=glorot(subs[2], (N_OUTPUTS, HIDDEN)), b3=np.zeros(N_OUTPUTS),
        target_means=np.zeros(N_OUTPUTS), target_stds=np.ones(N_OUTPUTS))


def note_grid(n_ranks):
    """The reference's grid: PER_RANK notes per rank on linspace(48, 84),
    velocity 0.8."""
    g = np.linspace(48.0, 84.0, n_ranks * PER_RANK)
    return g, np.full_like(g, 0.8)


def step_terms(weights, g, v):
    """Render → harmonic ladder → residual targets → the loss's terms:
    (numerator, count) of `calib.train.masked_huber_terms` on the notes
    g, v (NumPy), on the weights' device."""
    from openwurli_tpu_torch import voice
    from openwurli_tpu_torch.calib import goertzel, train

    device = weights.w1.device
    vparams, detuned = voice.note_on_params(g, v, SR, mlp_enabled=False)
    vstate = voice.init_state(vparams, detuned, v, SR,
                              voice.default_note_seed(g))
    _, audio = voice.render(vparams, vstate, N_SAMPLES, device=device)
    _, mags = goertzel.harmonic_ladder(audio.T, detuned, SR,
                                       n_harmonics=6, refine=False)
    rel_db = 20.0 * torch.log10(torch.clamp(mags[:, 1:6], min=1e-12)
                                / torch.clamp(mags[:, :1], min=1e-12))
    n = len(g)
    targets = torch.cat([rel_db * 0.1, torch.ones_like(rel_db),
                         torch.ones((n, 1), dtype=torch.float64,
                                    device=device)], dim=-1)
    inputs = torch.from_numpy(np.stack([(g - 21.0) / 87.0, v], axis=-1))
    batch = train.TrainBatch(
        inputs=inputs.to(device), targets=targets,
        mask=torch.ones_like(targets, dtype=torch.bool),
        weights=torch.ones(n, dtype=torch.float64, device=device))
    return train.masked_huber_terms(weights, batch)


def train_step(weights, g, v, mesh=None):
    """One SGD step on MlpWeights of float64 tensors → (new weights,
    loss). With a mesh, g and v are this rank's notes and the numerator,
    the count and the numerator's gradient are summed over the ranks;
    without, they are the whole batch's."""
    leaves = mlp.MlpWeights(*[w.detach().clone().requires_grad_(True)
                              for w in weights])
    num, den = step_terms(leaves, g, v)
    if mesh is None:
        loss = num / torch.clamp(den, min=1.0)
        grads = torch.autograd.grad(loss, list(leaves))
    else:
        d_num = torch.autograd.grad(num, list(leaves))
        flat = torch.cat([num.detach().reshape(1), den.reshape(1)]
                         + [d.reshape(-1) for d in d_num])
        dist.all_reduce(flat)
        scale = torch.clamp(flat[1], min=1.0)
        loss = flat[0] / scale
        sizes = [d.numel() for d in d_num]
        grads = [x.reshape(d.shape) / scale
                 for x, d in zip(torch.split(flat[2:], sizes), d_num)]
    new = mlp.MlpWeights(*[w.detach() - LEARNING_RATE * d
                           for w, d in zip(leaves, grads)])
    return new, loss.detach()


def _numpy(weights):
    return mlp.MlpWeights(*[w.detach().cpu().numpy() for w in weights])


def phase1(mesh, weights_np):
    """The sharded training step against the one-process step; returns
    rank 0's numbers (others None)."""
    from openwurli_tpu_torch import convert
    from openwurli_tpu_torch.parallel import mesh as meshlib

    n = mesh.world_size
    g, v = note_grid(n)
    weights = meshlib.replicate(mesh, convert.mlp_weights_from_numpy(
        weights_np, mesh.device))
    g_loc, v_loc = meshlib.shard_batch(mesh, (g, v))
    new_sh, loss_sh = train_step(weights, g_loc, v_loc, mesh)
    if not bool(torch.isfinite(loss_sh)):
        raise RuntimeError(f"non-finite sharded loss {float(loss_sh)}")
    delta = float((new_sh.w3 - weights.w3).abs().max())
    if not delta > 0.0:
        raise RuntimeError("sharded training step produced no update")
    # every rank holds the same weights after the step
    flat = torch.cat([w.reshape(-1) for w in new_sh])
    every = meshlib.all_gather(mesh, flat[None], dim=0)
    if not bool((every == flat[None]).all()):
        raise RuntimeError("the ranks' weights differ after the step")
    if mesh.rank:
        return None

    new_1, loss_1 = train_step(weights, g, v)
    err_loss = float((loss_sh - loss_1).abs())
    err_w = max(float((a - b).abs().max()) for a, b in zip(new_sh, new_1))
    if err_loss > STEP_GATE:
        raise RuntimeError(f"sharded loss deviates: {err_loss:.3e}")
    if err_w > STEP_GATE:
        raise RuntimeError(f"sharded weights deviate: {err_w:.3e}")
    line = (f"dryrun_multichip({n}): platform={mesh.device.type} "
            f"mesh=({n},) loss={float(loss_sh):.6f} dW3={delta:.3e} "
            f"sharded-vs-single |dloss|={err_loss:.1e} |dW|max="
            f"{err_w:.1e} replicated-on={n} devices — OK")
    print(line, flush=True)
    return {"loss": float(loss_sh), "weights": _numpy(new_sh),
            "loss_1": float(loss_1), "weights_1": _numpy(new_1),
            "dW3": delta, "line": line}


def phase2(mesh, midis=None, velocity=0.8, seconds=None, t_tile=None,
           **controls):
    """`fast.render_grid_sharded` against the standalone `render_grid` of
    each rank's block of streams, bit for bit; returns (sharded, per-shard
    renders), each (T, S) on every rank. Default geometry: the
    reference's, 16 voices per stream (uniform 40-88, seed 0), one stream
    per rank, one `mono_chain.T_TILE` of samples at 44.1 kHz. controls:
    `render_grid`'s volume, depth, character, warm_seconds; an array holds
    one value per stream."""
    from openwurli_tpu_torch import fast
    from openwurli_tpu_torch.kernels import mono_chain as mc
    from openwurli_tpu_torch.parallel import mesh as meshlib

    n = mesh.world_size
    if midis is None:
        midis = np.random.default_rng(0).uniform(40.0, 88.0, size=(n, 16))
    t_tile = t_tile or mc.T_TILE
    seconds = t_tile / 44100.0 if seconds is None else seconds
    s = len(midis)
    out = fast.render_grid_sharded(mesh, midis, velocity, seconds,
                                   t_tile=t_tile, **controls)
    t = int(round(seconds * 44100.0))
    if tuple(out.shape) != (t, s) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"sharded render: shape {tuple(out.shape)} or "
                           "non-finite values")
    if len(torch.unique(out[-1])) != s:
        raise RuntimeError("streams collapsed across shards")
    rows = meshlib.block(mesh, s)
    own = fast.render_grid(
        midis[rows], np.broadcast_to(velocity, np.shape(midis))[rows],
        seconds, t_tile=t_tile, device=mesh.device,
        **{k: np.asarray(c)[rows] if np.ndim(c) else c
           for k, c in controls.items()})
    oracle = meshlib.all_gather(mesh, own, dim=1)
    bits, want = out.view(torch.int32), oracle.view(torch.int32)
    if not torch.equal(bits, want):
        raise RuntimeError(f"sharded render is not bit-identical to the "
                           f"per-shard standalone renders "
                           f"({int((bits != want).sum())} samples)")
    if mesh.rank == 0:
        print(phase2_line(n), flush=True)
    return out, oracle


def phase2_line(n):
    return (f"dryrun_multichip({n}) phase 2: fused kernels sharded over "
            f"{n} devices, bit-identical to per-shard standalone renders "
            "— OK")


def _rank(rank, n, device, store_path, result_path, fn, args, kwargs):
    from openwurli_tpu_torch.parallel import mesh as meshlib

    if device == "cpu":
        torch.set_num_threads(1)
    backend = "nccl" if device == "cuda" else "gloo"
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        devices = ([f"cuda:{i}" for i in range(n)] if device == "cuda"
                   else ["cpu"] * n)
        result = fn(meshlib.make_mesh(devices), *args, **kwargs)
        dist.barrier()
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(meshlib.tree_map(
                    lambda x: x.cpu() if torch.is_tensor(x) else x,
                    result), f)
    finally:
        dist.destroy_process_group()


def run_ranks(n_ranks: int, device: str, fn, *args, **kwargs):
    """fn(mesh, *args, **kwargs) on n_ranks fresh processes, one rank
    each: gloo on the CPU (device "cpu"), NCCL on cuda:0 … cuda:N-1
    (device "cuda"), met at a file store in a temporary directory. Returns
    rank 0's result (its tensors moved to the CPU). A rank's exception
    raises here. fn and the arguments must pickle (fn a module-level
    function)."""
    n = int(n_ranks)
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} ranks need {n} CUDA devices, have "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.pkl")
        mp.spawn(_rank, args=(n, device, os.path.join(tmp, "store"),
                              result_path, fn, args, kwargs),
                 nprocs=n, join=True)
        with open(result_path, "rb") as f:
            return pickle.load(f)


def _phases(mesh, weights):
    from openwurli_tpu_torch.kernels import mono_chain as mc
    from openwurli_tpu_torch.kernels import render as kr
    from openwurli_tpu_torch.kernels import voice_bank as vb

    step = phase1(mesh, weights)
    phase2(mesh)
    return {"step": step, "launches": {
        "voice_render": kr.VOICE_RENDER_LAUNCHES,
        "voice_bank": vb.LAUNCHES_BY_KERNEL["voice_bank"],
        "mono_chain": mc.KERNEL_LAUNCHES,
        "plain": kr.VOICE_RENDER_PLAIN_CALLS + vb.PLAIN_CALLS
        + mc.PLAIN_CALLS}}


def main(n_devices: int, device: str = "cuda"):
    """The dry run over n_devices ranks on `device` ("cuda": NCCL on
    cuda:0 … cuda:N-1; "cpu": gloo processes), from `init_weights(0)`.
    Returns rank 0's {"step": phase 1's numbers, "lines": the two "— OK"
    lines it printed, "launches": the kernel launches and plain-version
    calls its process made}."""
    res = run_ranks(n_devices, device, _phases, init_weights(0))
    res["lines"] = [res["step"]["line"], phase2_line(int(n_devices))]
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    return main(args.n, args.device)


if __name__ == "__main__":
    cli()
