"""The (data, model) layout of the ranks (counterpart of
street_gaussians_ns_tpu/parallel/mesh.py: `make_mesh`, `multihost_init`).

The JAX package lays its devices out as a `jax.sharding.Mesh` with axes
('data', 'model'): a data row trains on its own camera, a model column
holds a shard of the background gaussians. Here every rank of the world
is one device of that mesh, in row-major order (rank = row * model +
column, JAX's `devices.reshape(data, model)`), and each axis is a
`torch.distributed` group: the data group of a rank is its column (the
ranks that hold the same shard and train on different cameras), its model
group its row (the ranks that render one camera together).

A group of one rank makes no collective call (parallel.collectives), so a
(1, 1) mesh runs the single-device arithmetic exactly.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) layout."""

    data: int                 # rows: cameras per step
    model: int                # columns: background shards
    row: int                  # this rank's data row
    col: int                  # this rank's model column
    data_group: object        # the ranks of this column (None: world of 1)
    model_group: object       # the ranks of this row (None: world of 1)
    device: torch.device


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "nccl",
                   timeout_s: float = 600.0) -> None:
    """Join the process group at tcp://<coordinator> as rank process_id of
    num_processes, with the backend named: "nccl" for CUDA tensors,
    "gloo" for CPU tensors (and for CUDA tensors only when the caller
    names it: two ranks that share one card). A world of one process
    without a coordinator starts a group of one on a local port. Already
    initialised: checks the rank, the world size and the backend. A
    failure raises; nothing
    falls back to a world of one."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    n = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if dist.is_initialized():
        have = (dist.get_rank(), dist.get_world_size(), dist.get_backend())
        if have != (rank, n, backend):
            raise RuntimeError(
                f"process group already initialised as rank {have[0]} of "
                f"{have[1]} on {have[2]}, asked for rank {rank} of {n} on "
                f"{backend}")
        return
    if coordinator is None:
        if n != 1:
            raise ValueError(f"{n} processes need a coordinator address")
        coordinator = f"127.0.0.1:{free_port()}"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def free_port() -> int:
    """A free TCP port on localhost (bind to port 0)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(data: Optional[int] = None, model: Optional[int] = None,
              device="cuda") -> Mesh:
    """The (data, model) layout of the initialised world's ranks, as the
    JAX function fills a missing axis: both None -> (world, 1); one None
    -> the world divided by the other. data * model must equal the world
    size. Every rank must make this call (it creates the groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(multihost_init)")
    n = dist.get_world_size()
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not match the world "
                         f"size {n}")
    rank = dist.get_rank()
    row, col = divmod(rank, model)
    data_group = model_group = None
    # Every rank creates every group, in one order (new_group's contract).
    for c in range(model):
        g = dist.new_group([r * model + c for r in range(data)])
        if c == col:
            data_group = g
    for r in range(data):
        g = dist.new_group([r * model + c for c in range(model)])
        if r == row:
            model_group = g
    return Mesh(data=data, model=model, row=row, col=col,
                data_group=data_group, model_group=model_group,
                device=torch.device(device))
