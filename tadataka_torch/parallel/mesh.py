"""Device meshes and the collectives of the sharded paths (counterpart of
``tadataka_tpu/parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device``s with axis names, the
counterpart of ``jax.sharding.Mesh`` in JAX's single-controller model:
one process drives all of its shards, one after another, each on its own
device.  A device may repeat: ``["cpu"] * 8`` gives eight CPU shards and
``["cuda:0"] * 4`` four shards on one card.  Once a process group is up
(``parallel/multihost.py``) a mesh spans every process; each shard
records the rank that drives it, and each process runs its own shards.

In place of JAX's ``NamedSharding``s, :func:`shard` cuts a tensor into
the blocks of this process's shards (each a contiguous tensor of its own
on its shard's device), :func:`replicate` puts a tensor, or a tuple of
them, on every shard's device, and :func:`unshard` puts the blocks back
together.  The collectives:

- :func:`psum`: the shards' values summed in fixed shard order on one
  device and sent back to each shard; across processes each process sums
  its own shards in that order, then ``all_reduce`` adds the processes'
  sums.
- :func:`neighbour_columns`: the one-column exchange with the left and
  right neighbours (JAX's ``lax.ppermute`` of the regularization halo),
  zeros at the mesh's ends.  Across processes it is an ``all_reduce`` of
  a zeroed buffer into which each process writes its own shards' edge
  columns (exact: every other term is zero), which gloo and NCCL both
  take.
"""

import numpy as np
import torch
import torch.distributed as dist

from tadataka_torch.device import upload


def process_index():
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count():
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


class Mesh:
    """``devices``: an array (any shape) of devices; ``axis_names``: one
    name per axis; ``ranks``: the rank driving each shard (same shape;
    all this process's by default)."""

    def __init__(self, devices, axis_names, ranks=None):
        given = np.asarray(devices, dtype=object)
        shape = given.shape
        self.devices = np.empty(shape, dtype=object)
        for index in np.ndindex(shape):
            self.devices[index] = torch.device(given[index])
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")
        if ranks is None:
            ranks = np.full(shape, process_index(), dtype=np.int64)
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(shape)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    @property
    def local_shards(self):
        """Flat indices of the shards this process drives, in order."""
        return [int(i) for i in np.flatnonzero(
            self.ranks.ravel() == process_index())]

    @property
    def local_devices(self):
        flat = self.devices.ravel()
        return [flat[i] for i in self.local_shards]

    @property
    def spans_processes(self):
        return len(set(self.ranks.ravel().tolist())) > 1


def make_mesh(devices=None, axis_name="shard"):
    """A one-axis mesh.  ``devices``: this process's devices, by default
    its CUDA devices (raises without a card; there is no CPU fallback).
    Once a process group of more than one process is up, the mesh spans
    every process: each contributes its devices, in rank order."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices=['cpu', ...] to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [str(torch.device(d)) for d in devices]
    ranks = [process_index()] * len(devices)
    if process_count() > 1:
        every = [None] * process_count()
        dist.all_gather_object(every, devices)
        devices = [d for own in every for d in own]
        ranks = [r for r, own in enumerate(every) for _ in own]
    return Mesh(devices, (axis_name,), np.asarray(ranks))


def default_mesh():
    return make_mesh()


# ----------------------------------------------------- placing tensors

def place(x, device):
    """``x`` as a contiguous tensor of its own on ``device``; from the
    host through pinned memory without blocking."""
    device = torch.device(device)
    if x.device == device:
        return x.clone(memory_format=torch.contiguous_format)
    if x.device.type == "cpu" and device.type == "cuda":
        return upload(x.contiguous(), device)
    return x.contiguous().to(device)


def to_device(tree, device):
    """A tensor, or a (named) tuple / list of them, on ``device``;
    tensors already there are shared, not copied."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == torch.device(device) else \
            place(tree, device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(x, device) for x in tree)
    return tree


def replicate(mesh, tree):
    """``tree`` on each of this process's shards' devices (a list in
    shard order; shards on one device share one copy)."""
    copies = {}
    out = []
    for device in mesh.local_devices:
        if device not in copies:
            copies[device] = to_device(tree, device)
        out.append(copies[device])
    return out


def shard(mesh, x, dim=0):
    """This process's blocks of ``x`` cut into ``mesh.size`` equal
    blocks along ``dim``: a list in shard order, each block a contiguous
    tensor of its own on its shard's device."""
    n = mesh.size
    if x.shape[dim] % n != 0:
        raise ValueError(f"shard: size {x.shape[dim]} of dim {dim} does "
                         f"not divide by the mesh size {n}")
    blocks = torch.chunk(x, n, dim=dim)
    return [place(blocks[i], d)
            for i, d in zip(mesh.local_shards, mesh.local_devices)]


def unshard(mesh, blocks, dim=0, device=None):
    """The whole tensor from this process's equal blocks (``shard``'s
    layout), on ``device`` (the first local shard's by default).  Across
    processes every process gets every block (an ``all_reduce`` of a
    zeroed tensor into which each process writes its own blocks)."""
    device = torch.device(device) if device is not None else \
        mesh.local_devices[0]
    blocks = [b.to(device) for b in blocks]
    if not mesh.spans_processes:
        return torch.cat(blocks, dim=dim)
    size = blocks[0].shape[dim]
    shape = list(blocks[0].shape)
    shape[dim] = size * mesh.size
    out = torch.zeros(shape, dtype=blocks[0].dtype, device=device)
    for i, b in zip(mesh.local_shards, blocks):
        out.narrow(dim, i * size, size).copy_(b)
    dist.all_reduce(out)
    return out


# ---------------------------------------------------------- collectives

def psum(mesh, values):
    """The sum over the mesh's shards of ``values`` (this process's, one
    per local shard, in shard order): summed left to right on the first
    local shard's device, then across processes by ``all_reduce``, and
    returned as a list with the sum on each local shard's device."""
    devices = mesh.local_devices
    root = devices[0]
    total = values[0].to(root, copy=True)
    for v in values[1:]:
        total = total + v.to(root)
    if mesh.spans_processes:
        dist.all_reduce(total)
    copies = {root: total}
    return [copies.setdefault(d, total.to(d)) for d in devices]


def neighbour_columns(mesh, blocks):
    """For column blocks (..., w) of this process's shards, each shard's
    (left, right) halo columns (..., 1): the left neighbour's last column
    and the right neighbour's first, zeros past the mesh's first and last
    shards (the image edges)."""
    n = mesh.size
    local = mesh.local_shards
    devices = mesh.local_devices
    if mesh.spans_processes:
        root = devices[0]
        shape = tuple(blocks[0].shape[:-1])
        edges = torch.zeros((n,) + shape + (2,), dtype=blocks[0].dtype,
                            device=root)
        for i, b in zip(local, blocks):
            edges[i, ..., 0] = b[..., 0].to(root)
            edges[i, ..., 1] = b[..., -1].to(root)
        dist.all_reduce(edges)
        first = [edges[i, ..., 0:1] for i in range(n)]
        last = [edges[i, ..., 1:2] for i in range(n)]
    else:
        first = [b[..., :1] for b in blocks]
        last = [b[..., -1:] for b in blocks]
    # a mesh in one process: local == range(n)
    out = []
    for b, i, device in zip(blocks, local, devices):
        zero = torch.zeros_like(b[..., :1])
        out.append((last[i - 1].to(device) if i > 0 else zero,
                    first[i + 1].to(device) if i < n - 1 else zero))
    return out
