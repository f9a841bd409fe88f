"""Process groups and the ('data', 'time') device mesh on torch.distributed.

Counterpart of llckbdm_tpu/parallel/mesh.py.  One rank per device.  Axis
convention (SURVEY.md §2 parallel-axis table):
  'data'  — voxel-batch row partitioning (outermost, so that each host keeps
            a contiguous voxel block and the 'time' collectives stay on one
            host)
  'time'  — optional signal/time-axis partitioning of the refinement's normal
            equations (the amplitude-RHS exchange, BASELINE.json:5)

The backend and the device are always the caller's choice: NCCL for CUDA
devices, gloo for the CPU.  Gloo also carries CUDA tensors (through host
memory), which is how two ranks share one card, where NCCL refuses.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def distributed_init(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0, *, backend: str,
                     device: str | torch.device) -> None:
    """Join this process to the default process group.

    coordinator : the rendezvous, an ``init_method`` URL (``tcp://host:port``,
                  ``file:///path``) or ``host:port``.  None only for a single
                  process, which then needs no rendezvous.
    backend     : ``"nccl"`` or ``"gloo"``.
    device      : this rank's device (``"cuda:<local index>"``, ``"cpu"``).

    This call binds the rank to its card: a CUDA device becomes the
    process's current device (which ``parallel.grid`` places its tensors
    on), and under NCCL it is also passed as ``device_id``, so that NCCL
    creates its communicator on that card at once instead of guessing it
    from the global rank.  The index is the card's on this host (the
    launcher's ``LOCAL_RANK``), not the global rank.  An index-less
    ``"cuda"`` means the current device in a single process and raises in
    a group of several, where it would put every rank of a host on one
    card.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            if num_processes != 1:
                raise ValueError(
                    f"device 'cuda' names no card for rank {process_id} of "
                    f"{num_processes}; pass 'cuda:<local index>', the "
                    f"card's index on this host (LOCAL_RANK)")
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    # device_id acts only under NCCL (an eager communicator, split for
    # subgroups); gloo is given none
    bind = {"device_id": device} if backend == "nccl" else {}
    if coordinator is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a coordinator")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **bind)
        return
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id, **bind)


def make_mesh(axis_sizes: dict[str, int], device_type: str) -> DeviceMesh:
    """Build a named mesh over all ranks, e.g.
    ``make_mesh({'data': 4, 'time': 2}, 'cuda')``.

    Axis order in the dict is the rank-grid order: the LAST axis varies
    fastest, so put 'time' last to keep its collectives on adjacent ranks
    (the GPUs of one host).  Every rank of the process group must call it.
    """
    shape = tuple(axis_sizes.values())
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {have}")
    if have > n:
        raise ValueError(f"mesh {axis_sizes} covers {n} of the {have} ranks; "
                         f"every rank must be in it")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_sizes))


def auto_mesh(time_shards: int = 1, *, device_type: str) -> DeviceMesh:
    """All ranks: 'data' x optional 'time' mesh."""
    n = dist.get_world_size()
    if n % time_shards:
        raise ValueError(f"{n} devices not divisible by time={time_shards}")
    return make_mesh({"data": n // time_shards, "time": time_shards},
                     device_type)
