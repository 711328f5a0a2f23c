"""Multi-device semi-dense depth update (counterpart of
``tadataka_tpu/parallel/sharded_semi_dense.py``).

Two layouts of the pixel grid over a mesh (``parallel/mesh.py``); the
key and ref images are replicated on every shard's device:

- rows: :func:`sharded_update_depth` runs the scattered estimator
  (``estimator.update_depth(row_offset=)``) on each shard's block of
  rows.  No collective.
- columns: :func:`make_sharded_update_sweep` runs the plane sweep
  (``sweep.update_depth_sweep(col_offset=)``) on each shard's block of
  columns, one ``ssd_search`` kernel launch a shard on the card, then
  the 3x3 regularization with a one-column halo from each neighbour
  (:func:`_regularize_halo`), the only exchange of the step.

Each block is bit-equal to the same rows or columns of the one-device
update: every pixel's arithmetic is the same.  The sharded functions
take whole tensors and return, for each output, the list of this
process's blocks in shard order, each on its shard's device;
``mesh.unshard`` puts them together.
"""

from functools import partial

import torch

from tadataka_torch.flags import Flag
from tadataka_torch.parallel.mesh import (
    neighbour_columns, replicate, shard)
from tadataka_torch.vo.semi_dense.estimator import safe_invert, update_depth
from tadataka_torch.vo.semi_dense.params import DEFAULT_N_REF_SAMPLES
from tadataka_torch.vo.semi_dense.regularization import _box3_rows
from tadataka_torch.vo.semi_dense.sweep import update_depth_sweep


def _run_sharded(mesh, dim, update, keyframe, refframes, age_map,
                 prior_depth, prior_variance, params):
    """``update(shard index, keyframe, refframes, age, prior depth, prior
    variance, params)`` on each local shard's block along ``dim``."""
    shared = replicate(mesh, (keyframe, refframes, params))
    blocks = [shard(mesh, x, dim)
              for x in (age_map, prior_depth, prior_variance)]
    outs = [update(i, kf, rf, age, depth, var, p)
            for i, (kf, rf, p), age, depth, var in zip(
                mesh.local_shards, shared, *blocks)]
    return tuple(list(x) for x in zip(*outs))


def sharded_update_depth(mesh, keyframe, refframes, age_map, prior_depth,
                         prior_variance, params,
                         n_ref_samples=DEFAULT_N_REF_SAMPLES):
    """update_depth with the pixel grid row-sharded over ``mesh``.

    Requires H to divide evenly by the mesh size (pad rows otherwise).
    Returns (depth_blocks, variance_blocks, flag_blocks), row blocks.
    """
    f = make_sharded_update_depth(mesh, tuple(prior_depth.shape),
                                  n_ref_samples=n_ref_samples)
    return f(keyframe, refframes, age_map, prior_depth, prior_variance,
             params)


def make_sharded_update_depth(mesh, shape,
                              n_ref_samples=DEFAULT_N_REF_SAMPLES):
    """The row-sharded update for a (H, W) map shape."""
    n = mesh.size
    H, _W = shape
    if H % n != 0:
        raise ValueError(f"H={H} must divide by the mesh size {n}")
    rows = H // n

    def local(i, keyframe, refframes, age, depth, variance, params):
        return update_depth(keyframe, refframes, age, depth, variance,
                            params, n_ref_samples=n_ref_samples,
                            row_offset=i * rows)

    return partial(_run_sharded, mesh, 0, local)


# --------------------------- fast path: column-sharded plane sweep

def make_sharded_update_sweep(mesh, shape, plan, regularize=True):
    """The planned plane sweep with the pixel grid COLUMN-sharded over
    ``mesh``.

    Each shard runs ``update_depth_sweep`` on its block of W / n columns
    (``col_offset`` mode: the whole key and ref images are sampled at the
    block's pixels), with no exchange; with ``regularize`` the 3x3
    smoothing then takes one halo column from each neighbour
    (:func:`_regularize_halo`) and equals ``regularization.regularize``
    on the whole map.

    ``plan`` is a ``fast.UpdatePlan`` with path == 'tent'.  Returns a
    callable (keyframe, refframes, age, prior_depth, prior_variance,
    params) -> (depth_blocks, variance_blocks, flag_blocks).  JAX's
    ``use_pallas`` has no counterpart: on the card each shard launches
    the ``ssd_search`` kernel, on the CPU it runs its plain version.
    """
    n = mesh.size
    _H, W = shape
    if W % n != 0:
        raise ValueError(f"W={W} must divide by the mesh size {n}")
    if plan.path != 'tent':
        raise ValueError("sharded fast update supports the tent plan; "
                         f"got {plan.path!r}")
    cols = W // n

    def local(i, keyframe, refframes, age, depth, variance, params):
        return update_depth_sweep(
            keyframe, refframes, age, depth, variance, params,
            n_planes=plan.n_planes, redirect=plan.redirect,
            col_offset=i * cols)

    def run(*args):
        d, v, f = _run_sharded(mesh, 1, local, *args)
        if regularize:
            d = _regularize_halo(mesh, d, v, f)
        return d, v, f

    return run


def _regularize_halo(mesh, depth_blocks, variance_blocks, flag_blocks):
    """3x3 inverse-variance-weighted smoothing under column sharding.

    Takes one column of the two box-sum INPUT maps from each neighbour
    (``mesh.neighbour_columns``: zeros at the image's left and right
    edges, the zero padding of the one-device sum), then sums the
    extended block with the shifted adds, in the order, of
    ``regularization._box3``; so each block equals its columns of
    ``regularization.regularize`` on the whole map.
    Parity: vo/semi_dense/regularization.py (regularization.rs:5-49).
    """
    inputs = []
    for depth, variance, flags in zip(depth_blocks, variance_blocks,
                                      flag_blocks):
        success = (flags == int(Flag.SUCCESS)).to(depth.dtype)
        inv_var = safe_invert(variance) * success
        inputs.append(torch.stack([safe_invert(depth) * inv_var, inv_var]))
    out = []
    for depth, x, (left, right) in zip(depth_blocks, inputs,
                                       neighbour_columns(mesh, inputs)):
        numerator, denominator = _box3_rows(
            torch.cat([left, x, right], dim=-1))
        smoothed = safe_invert(numerator
                               / torch.clamp(denominator, min=1e-12))
        out.append(torch.where(denominator > 0, smoothed, depth))
    return out
