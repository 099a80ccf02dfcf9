"""Multi-device sharding for calibration sweeps and training, on
`torch.distributed`. Port of `openwurli_tpu/parallel/mesh.py`.

The reference builds a `jax.sharding.Mesh`: one controller drives N
devices, and XLA partitions the batch axis. Here a mesh is N ranks of one
process group, one device each (NCCL on CUDA devices, gloo on CPU ones).
Each rank holds the block of the batch axis that `NamedSharding(mesh,
P("data"))` gives its device, runs the renders on it alone (notes are
independent: no communication), and the results meet in an `all_gather`,
so that every rank holds the global array the reference's sharded array
shows. Reductions that a training step needs are `all_reduce`s over the
group.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


class Mesh(NamedTuple):
    """This rank's place in the mesh: its rank, the group's size and its
    device. The group is the default process group."""
    rank: int
    world_size: int
    device: torch.device


def _backend(devices):
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh spans CPU devices or CUDA devices, got "
                         f"{[str(d) for d in devices]}")
    return "nccl" if kinds == {"cuda"} else "gloo"


def make_mesh(devices=None) -> Mesh:
    """The mesh over `devices`, one per rank of the default process group
    (rank r runs on devices[r]): NCCL for CUDA devices, gloo for CPU ones.

    With no process group set up, `devices` must be one device, and a
    one-rank group is made on it; devices=None then means `cuda:0`. Inside
    a group of N ranks (`dryrun.run_ranks` starts one), devices=None means
    `cuda:0` … `cuda:N-1`. A group whose backend does not fit the devices
    raises: a CUDA mesh never runs on gloo."""
    if devices is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None
               else d for d in devices]
    backend = _backend(devices)
    if not dist.is_initialized():
        if len(devices) != 1:
            raise ValueError(f"{len(devices)} devices need a process group "
                             "of as many ranks (dryrun.run_ranks starts one)")
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"the devices need {backend}")
    if dist.get_world_size() != len(devices):
        raise ValueError(f"{len(devices)} devices for a group of "
                         f"{dist.get_world_size()} ranks")
    rank = dist.get_rank()
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank, len(devices), device)


def tree_map(fn, tree):
    """fn over the leaves of named tuples, tuples, lists and dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def block(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a leading axis of n: the contiguous block
    r·n/N … (r+1)·n/N − 1, as `NamedSharding(mesh, P("data"))` places it
    on the mesh's r-th device."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.world_size} ranks")
    k = n // mesh.world_size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh, tree):
    """This rank's block of the leading axis of every leaf of a pytree
    (tuples, lists, dicts, named tuples). Tensors go to the rank's device;
    NumPy leaves stay on the host, where the port's note-on packers run."""
    def leaf(x):
        if torch.is_tensor(x):
            return x[block(mesh, x.shape[0])].to(mesh.device)
        x = np.asarray(x)
        return x[block(mesh, x.shape[0])]
    return tree_map(leaf, tree)


def replicate(mesh: Mesh, tree):
    """Every leaf as a tensor on this rank's device, holding rank 0's
    values (a broadcast from rank 0)."""
    def leaf(x):
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        t = t.to(mesh.device).contiguous().clone()
        dist.broadcast(t, src=0)
        return t
    return tree_map(leaf, tree)


def all_gather(mesh: Mesh, x, dim: int = -1):
    """The ranks' blocks of x (equal shapes) joined along `dim` in rank
    order: the global array, on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


def all_reduce_max(mesh: Mesh, values):
    """Elementwise maximum of a sequence of integers over the ranks."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(int(v) for v in t.cpu())


def sharded_grid_render(mesh: Mesh, notes, velocities, duration_s,
                        sample_rate, mlp_enabled=False):
    """Render a flattened note × velocity grid sharded over the mesh.

    Each rank packs its block of the G notes, renders it with
    `voice.render` on its device (kernel E4 on the card) and gathers the
    blocks: returns (num_samples, G) float64 on every rank. The voice scan
    is pure data parallelism; the only collective is the gather."""
    from openwurli_tpu_torch import voice

    g, v = np.broadcast_arrays(np.asarray(notes, dtype=np.float64),
                               np.asarray(velocities, dtype=np.float64))
    g, v = shard_batch(mesh, (g, v))
    vparams, detuned = voice.note_on_params(
        g, v, sample_rate, mlp_enabled=mlp_enabled)
    state = voice.init_state(vparams, detuned, v, sample_rate,
                             voice.default_note_seed(g))
    n = int(duration_s * sample_rate)
    _, out = voice.render(vparams, state, n, device=mesh.device)
    return all_gather(mesh, out, dim=1)
