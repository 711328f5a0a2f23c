"""Checkpoint / resume for pipeline state (counterpart of
``tadataka_tpu/checkpoint.py``), in the JAX package's file format.

A tree of tensors (dicts, lists, tuples, NamedTuples such as
``SemiDenseVOState`` and ``Pose``) is saved to one .npz: each leaf as
``leaf_i`` and every leaf's key path as JSON bytes under ``__paths__``.
The paths are those of ``jax.tree_util``: a dict key as ``str`` (keys in
sorted order), a sequence index as ``int``, a NamedTuple field by its
name; ``None`` is an empty subtree.  So a checkpoint written by either
package loads in the other: the state NamedTuples of both have the same
fields in the same order, and this is how VO state carries across.
"""

import json

import numpy as np
import torch


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_flatten_with_path(tree, path=()):
    """[(key path, leaf)] in the order of ``jax.tree_util``."""
    children = _children(tree)
    if children is None:
        return [(path, tree)]
    return [item for key, child in children
            for item in tree_flatten_with_path(child, path + (key,))]


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    children = _children(template)
    if children is None:
        return next(leaves)
    if template is None:
        return None
    values = [_rebuild(child, leaves) for _, child in children]
    if isinstance(template, dict):
        return dict(zip((k for k in sorted(template)), values))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*values)
    return type(template)(values)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree):
    """Save any tree of tensors/arrays/scalars to ``path`` (.npz).

    Alongside the leaves, the key path of every leaf is stored so the
    checkpoint is self-describing: ``load_pytree`` can rebuild a nested
    dict/list skeleton with no template.
    """
    flat = tree_flatten_with_path(tree)
    arrays = {f"leaf_{i}": _host(leaf) for i, (_, leaf) in enumerate(flat)}
    paths = [list(p) for p, _ in flat]
    arrays["__paths__"] = np.frombuffer(
        json.dumps(paths).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _skeleton_from_paths(paths, leaves):
    """Nested dicts (str keys) / lists (int keys) holding the leaves."""
    root = {}
    for keys, leaf in zip(paths, leaves):
        if not keys:
            return leaf                     # the tree is a single leaf
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        vals = {k: listify(v) for k, v in node.items()}
        if vals and all(isinstance(k, int) for k in vals):
            return [vals[i] for i in sorted(vals)]
        return vals

    return listify(root)


def load_pytree(path, like=None):
    """Restore a tree saved by ``save_pytree`` (by either package).

    With ``like`` (a template tree), leaves load into its exact structure
    -- required to get NamedTuples back -- and each leaf goes to its
    template leaf's device and dtype where that is a tensor (a numpy
    array otherwise).  Without it, the stored key paths rebuild a plain
    nested dict/list skeleton of CPU tensors in the same places.
    """
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    leaves = [data[f"leaf_{i}"] for i in range(n)]

    if like is None:
        paths = json.loads(bytes(data["__paths__"]).decode())
        return _skeleton_from_paths(
            paths, [torch.from_numpy(np.array(a)) for a in leaves])

    leaves_like = [leaf for _, leaf in tree_flatten_with_path(like)]
    if len(leaves_like) != n:
        raise ValueError(f"checkpoint has {n} leaves; template has "
                         f"{len(leaves_like)}")
    for i, (a, b) in enumerate(zip(leaves, leaves_like)):
        expected = tuple(b.shape) if hasattr(b, "shape") else None
        if expected is not None and tuple(a.shape) != expected:
            raise ValueError(
                f"leaf {i}: checkpoint shape {a.shape} != "
                f"expected {expected}")
    placed = [torch.from_numpy(np.array(a)).to(device=b.device,
                                                dtype=b.dtype)
              if isinstance(b, torch.Tensor) else a
              for a, b in zip(leaves, leaves_like)]
    return _rebuild(like, iter(placed))


def save_trajectory_tum(path, timestamps, poses):
    """Poses (camera->world) to TUM format (tum.py:19-29 equivalent)."""
    from scipy.spatial.transform import Rotation
    from tadataka_torch.dataset.tum import save_in_tum_format
    rotations = Rotation.from_matrix(np.stack([_host(p.R) for p in poses]))
    positions = np.stack([_host(p.t) for p in poses])
    save_in_tum_format(path, timestamps, rotations, positions)
