"""Data parallelism over a ``torch.distributed`` world.

Port of ``swtpu/parallel/mesh.py`` (and of ``init_distributed`` from
``swtpu/parallel/search.py``). JAX runs one controller that sees every
device and traces a ``shard_map``; PyTorch runs one process a device
(SPMD). So each rank is called with the whole host batch, as JAX's
controller is, takes its own slice of it, runs the one-card hot path on
that slice, and the result is a ``DTensor`` sharded over the mesh's one
axis, whose ``full_tensor()`` is JAX's result.

- ``init_distributed`` joins the world: its address, size and rank come
  from the arguments or from the ``torchrun`` environment
  (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``); a world of one process needs no call, as in JAX.
  Each rank's card is ``cuda:LOCAL_RANK % device_count``.
- ``make_mesh`` returns a 1-D ``DeviceMesh`` over the whole world, one
  rank a device. With no process group it starts a world of one process
  on an in-memory store, so a single process needs no launcher.
- ``data_parallel_scores`` keeps JAX's guard (the batch divides by the
  mesh size) and scores each rank's shard with ``best_engine``: the
  row-scan, affine or profile kernel on the card, the plain tier on the
  CPU.

The backend is NCCL for a world on the card and gloo on the CPU. Two
ranks cannot share one card under NCCL, so such a world (a test of the
mesh on one card) runs gloo with its kernels on the card. On the H100
(torch 2.11, two gloo ranks on one card), a ``DTensor`` on a CUDA mesh
killed both ranks (SIGSEGV) in ``full_tensor()``, while ``all_gather``,
``broadcast`` and ``all_reduce`` of CUDA tensors returned the right
values (``chip_smoke.py`` phase 40 checks the three each run);
point-to-point ``isend`` / ``irecv`` of CUDA tensors under gloo was not
tried. So a mesh's device type is where its collectives' tensors live:
``cuda`` under NCCL, ``cpu`` under gloo, whatever device the kernels run
on (``device=``, the card by default); and under gloo the port's own
exchanges (the sweep's rows, the gathered endpoint rows and top-k
candidates, a ``DTensor``'s shard) stage every CUDA tensor through the
host (``host_staged``), so one rule covers them all. Under NCCL they stay
on the card.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.utils.device import resolve_device

_LAUNCHER = (
    "start one process a device with torchrun (torchrun --nproc-per-node N "
    "-m swtpu_torch ...) or call swtpu_torch.parallel.init_distributed first"
)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> None:
    """Join a world of ``num_processes`` processes (no-op for one).

    ``coordinator``: ``host:port`` of rank 0, or an init URL
    (``tcp://...``, ``file://...``). Missing arguments come from the
    ``torchrun`` environment. ``backend``: ``"nccl"`` when ``device``
    (default: the card) is a CUDA device, else ``"gloo"``; a caller may
    pass either, and nothing switches it after a failure.
    """
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator is None:
        coordinator = f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}"
    if "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=coordinator, world_size=num_processes,
                            rank=process_id)


def make_mesh(n_devices: Optional[int] = None, axis: str = "pairs", device=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over the whole world, one rank
    a device. With no process group up it starts a world of one process
    for ``device`` (default: the card; NCCL there, gloo on the CPU).
    ``n_devices`` must equal the world's size. The mesh's device type is
    its backend's (module note)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                             f"{n_devices} processes: {_LAUNCHER}")
        if dev.type == "cuda":  # the rank's card, named before NCCL starts
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {world} "
                         f"processes: {_LAUNCHER}")
    kind = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return DeviceMesh(kind, list(range(world)), mesh_dim_names=(axis,))


def mesh_rank(mesh, axis: str):
    """(this rank's index on the mesh axis ``axis``, the axis's size)."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh's axes are {mesh.mesh_dim_names}, not {axis!r}")
    return mesh.get_local_rank(axis), mesh.size()


def host_staged(dev: torch.device) -> bool:
    """Whether the world's exchanges of ``dev`` tensors go through the
    host: CUDA tensors under gloo (module note)."""
    return dev.type == "cuda" and dist.get_backend() == "gloo"


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x`` in rank order, on ``x``'s device.
    A world of one gathers nothing (no collective, no host sync)."""
    if mesh.size() == 1:
        return x[None]
    wire = x.cpu() if host_staged(x.device) else x
    out = [torch.empty_like(wire) for _ in range(mesh.size())]
    dist.all_gather(out, wire.contiguous(), group=mesh.get_group())
    return torch.stack(out).to(x.device)


def shard_batch(arr, mesh, axis: str = "pairs"):
    """Shard a [B, ...] batch over the mesh's axis: a ``DTensor`` with
    ``Shard(0)``. Every rank passes the same whole batch; each keeps its
    slice (no scatter)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return distribute_tensor(arr, mesh, [Shard(0)], src_data_rank=None)


def data_parallel_scores(qs, ts, params: ScoringParams, mesh, axis: str = "pairs",
                         engine=None, device=None):
    """Batched SW scores with the batch sharded over ``axis``.

    qs: [B, n], ts: [B, m], the same whole batch on every rank, with B
    divisible by the mesh size. Each rank scores its B / D pairs with
    ``best_engine(params)`` (or ``engine``) on ``device`` (default: the
    card). Returns the [B] int32 scores as a ``DTensor`` sharded over
    ``axis`` on the mesh's device type (``full_tensor()`` gathers them)."""
    from torch.distributed.tensor import DTensor, Shard

    from swtpu_torch.ops.variants import resolve_engine

    dev = resolve_device(device)
    r, D = mesh_rank(mesh, axis)
    B = len(qs)
    if B % D:
        raise ValueError(f"a batch of {B} pairs does not divide over a mesh of "
                         f"{D} devices")
    engine, _ = resolve_engine(params, engine, dev)
    s = B // D
    local = torch.as_tensor(engine(qs[r * s:(r + 1) * s], ts[r * s:(r + 1) * s]),
                            device=dev).to(torch.int32)
    return DTensor.from_local(local.to(mesh.device_type), mesh, [Shard(0)],
                              run_check=False)
