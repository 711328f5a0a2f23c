"""Multi-process launch: the process group and host-aware meshes
(counterpart of ``tadataka_tpu/parallel/multihost.py``).

:func:`initialize_distributed` joins this process to a
``torch.distributed`` process group; from then on ``make_mesh`` spans
every process, and the collectives of ``parallel/mesh.py`` (the BA's
``psum``, the sweep's halo columns) cross the process boundary through
the group.  For one process it does nothing, so the same entry point
runs everywhere.

The backend is chosen explicitly: ``nccl`` where each process owns a
card of its own, ``gloo`` on the CPU and where two processes share one
card (NCCL refuses two ranks on one GPU; gloo reduces CUDA tensors
through the host).

The collective-placement rule of the JAX module holds: the per-iteration
collectives (the BA's reduced camera system, the sweep's halo) go on the
fast ``shard`` axis of :func:`make_host_mesh`, within a host; the
``host`` axis is for bulk work that amortizes its transfers (frames).
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from tadataka_torch.parallel.mesh import Mesh, make_mesh, process_index


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Join the process group of a multi-process launch.

    Arguments default from the launcher's environment (``MASTER_ADDR``
    and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``: what ``torchrun``
    sets); ``coordinator_address`` is "host:port".  The call is a NO-OP
    for one process (num_processes in (None, 1)).  The backend is NCCL
    where this host has a card for each of its processes
    (``LOCAL_WORLD_SIZE``, else all of them), each process driving card
    ``LOCAL_RANK``; gloo otherwise.

    Returns (process_id, num_processes).
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))

    if num_processes > 1 and not dist.is_initialized():
        local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        backend = "nccl" if cards >= local else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(env.get("LOCAL_RANK",
                                              process_id % local)))
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return process_id, num_processes


def make_host_mesh(devices=None, intra_axis="shard", inter_axis="host"):
    """A 2-D (host, intra-host) mesh over every process's devices.

    ``devices``: this process's devices (its CUDA devices by default).
    The fast ``intra_axis`` spans one process's devices: put the
    per-iteration collectives there.  The slow ``inter_axis`` spans
    processes.  One process gets a (1, n_local) mesh.

    Devices are grouped EXPLICITLY by rank: row r holds rank r's
    devices, so no row straddles two processes.
    """
    flat = make_mesh(devices)
    order = np.argsort(flat.ranks, kind="stable")
    ranks = flat.ranks[order]
    n_hosts = len(set(ranks.tolist()))
    n_local = flat.size // n_hosts
    grid = flat.devices[order].reshape(n_hosts, n_local)
    ranks = ranks.reshape(n_hosts, n_local)
    for row in ranks:
        assert len(set(row.tolist())) == 1, "uneven devices per process"
    return Mesh(grid, (inter_axis, intra_axis), ranks)


def local_slice(mesh, global_array_len, inter_axis="host"):
    """(start, length) of this process's block of an inter-host-sharded
    leading axis (e.g. which frames of a sequence this process ingests).

    The remainder of a non-divisible length goes one each to the first
    hosts."""
    n_hosts = mesh.shape[inter_axis]
    idx = process_index()
    per, rem = divmod(global_array_len, n_hosts)
    start = idx * per + min(idx, rem)
    return start, per + (1 if idx < rem else 0)
