"""Distributed Schur-complement bundle adjustment (counterpart of
``tadataka_tpu/parallel/distributed_ba.py``).

Landmarks, and the observations of each, are sharded over a mesh
(``parallel/mesh.py``); each shard assembles its own V / W blocks and its
part of the reduced camera system, ``psum`` adds the (6M x 6M) system
over the shards, and the landmark back-substitution stays on each shard.
The only exchanges are ``psum``s of O(M^2) floats, whatever the landmark
count: an LM iteration's (U, e_cam) and error sums, and each damping
trial's (S, rhs) and error sums.

The arithmetic is that of ``ba/schur.py``: the sums over a shard's
observations add in observation order (``_scatter_sum``), the sums over
its points pairwise (``fixed_order_sum``), and the 3x3 inverses and the
reduced system's solve run on the host's LAPACK, so the CPU and the card
give the same bits.  The LM schedule of the JAX ``while_loop`` runs on
the host, which reads each trial's error once.
"""

import numpy as np
import torch

from tadataka_torch.ba.residuals import (
    projection_residuals, projection_jacobians)
from tadataka_torch.ba.schur import _layout, _scatter_sum
from tadataka_torch.core.rounding import (
    fixed_order_sum, matmul_small, sum_small)
from tadataka_torch.core.solvers import inv, solve
from tadataka_torch.parallel.mesh import place, psum, replicate, unshard


def shard_observations(viewpoint_indices, point_indices, x_true,
                       n_points, n_devices):
    """Host-side layout: pad points to a multiple of n_devices and group
    observations by owning shard (each padded to equal length).

    Returns (vi_sh, pi_local_sh, x_sh, w_sh, points_per_shard) where arrays
    have leading axis n_devices and pi_local is the in-shard point index.
    """
    viewpoint_indices = np.asarray(viewpoint_indices)
    point_indices = np.asarray(point_indices)
    x_true = np.asarray(x_true)

    points_per_shard = -(-n_points // n_devices)
    shard_of = point_indices // points_per_shard
    counts = np.bincount(shard_of, minlength=n_devices)
    max_obs = int(counts.max()) if len(counts) else 1
    max_obs = max(max_obs, 1)

    vi_sh = np.zeros((n_devices, max_obs), dtype=np.int32)
    pi_sh = np.zeros((n_devices, max_obs), dtype=np.int32)
    x_sh = np.zeros((n_devices, max_obs, 2), dtype=np.float32)
    w_sh = np.zeros((n_devices, max_obs), dtype=np.float32)

    for d in range(n_devices):
        sel = np.where(shard_of == d)[0]
        n = len(sel)
        vi_sh[d, :n] = viewpoint_indices[sel]
        pi_sh[d, :n] = point_indices[sel] - d * points_per_shard
        x_sh[d, :n] = x_true[sel]
        w_sh[d, :n] = 1.0
    return vi_sh, pi_sh, x_sh, w_sh, points_per_shard


class _Shard:
    """One shard's observations (on its device) and their sum layout."""

    def __init__(self, vi, pi_local, x_true, w, M, n_local):
        self.vi, self.pi, self.x, self.w = vi, pi_local, x_true, w
        self.layout = _layout(vi, pi_local, M, n_local)

    def residuals(self, poses, points):
        return projection_residuals(poses, points, self.vi, self.pi, self.x)

    def error_sums(self, r):
        """(sum of the weighted squared residuals, sum of the weights)."""
        return fixed_order_sum(torch.stack([sum_small(r * r) * self.w,
                                            self.w]))


def _local_assemble(shard, poses, points_local):
    """Per-shard normal-equation blocks (U, V, W, e_cam, e_pt) and the
    error sums, each summed in observation order."""
    M = poses.shape[0]
    Nl = points_local.shape[0]
    by_view, by_point, by_pair = shard.layout
    r = shard.residuals(poses, points_local)
    A, B = projection_jacobians(poses, points_local, shard.vi, shard.pi)
    ww = shard.w[:, None, None]
    Awt = (A * ww).transpose(1, 2)
    Bwt = (B * ww).transpose(1, 2)
    O = r.shape[0]
    cam = _scatter_sum(torch.cat([matmul_small(Awt, A).reshape(O, 36),
                                  matmul_small(Awt, r[..., None])[..., 0]],
                                 1), by_view)
    pt = _scatter_sum(torch.cat([matmul_small(Bwt, B).reshape(O, 9),
                                 matmul_small(Bwt, r[..., None])[..., 0]], 1),
                      by_point)
    W = _scatter_sum(matmul_small(Awt, B), by_pair).reshape(Nl, M, 6, 3)
    return (cam[:, :36].reshape(M, 6, 6), pt[:, :9].reshape(Nl, 3, 3), W,
            cam[:, 36:], pt[:, 9:], shard.error_sums(r))


def _inverses(blocks):
    """inv of each (n, 3, 3) block, one host call a device."""
    out = [None] * len(blocks)
    by_device = {}
    for k, b in enumerate(blocks):
        by_device.setdefault(b.device, []).append(k)
    for ks in by_device.values():
        sizes = [blocks[k].shape[0] for k in ks]
        parts = torch.split(inv(torch.cat([blocks[k] for k in ks])), sizes)
        for k, part in zip(ks, parts):
            out[k] = part
    return out


def _schur_parts(W, V_inv, e_pt):
    """A shard's Y = W V^-1 and its (S, rhs) contributions
    -sum_n Y_nj W_nk^T and -sum_n Y_nj e_pt_n, summed pairwise over n."""
    M = W.shape[1]
    Y = matmul_small(W, V_inv[:, None])                    # (Nl, M, 6, 3)
    YW = matmul_small(Y[:, :, None], W[:, None].transpose(-1, -2))
    S = -fixed_order_sum(YW.permute(1, 3, 2, 4, 0)).reshape(6 * M, 6 * M)
    Ye = matmul_small(Y, e_pt[:, None, :, None])[..., 0]  # (Nl, M, 6)
    rhs = -fixed_order_sum(Ye.permute(1, 2, 0))           # (M, 6)
    return S, rhs


def _mean_error(mesh, sums):
    total = psum(mesh, sums)[0]
    return total[0] / torch.clamp(total[1], min=1.0)


def _spmd_lm(mesh, shards, poses, points, max_iter, initial_mu, nu,
             abs_threshold, rel_threshold, max_mu=1e12):
    """The LM loop over the local shards; the schedule of the JAX
    ``_spmd_lm`` (and of ``ba/schur.py``) on the host.  ``poses``: on
    the first local shard's device; ``points``: this process's blocks."""
    f32 = np.float32
    nu, max_mu = f32(nu), f32(max_mu)
    abs_thr, rel_thr = f32(abs_threshold), f32(rel_threshold)
    M = poses.shape[0]
    root = poses.device
    I3 = torch.eye(3, dtype=poses.dtype, device=root)
    I6 = torch.eye(6, dtype=poses.dtype, device=root)

    def error_of(po, pts):
        po_sh = replicate(mesh, po)
        return f32(_mean_error(mesh, [
            s.error_sums(s.residuals(p, x))
            for s, p, x in zip(shards, po_sh, pts)]).item())

    def lm_update(po, pts, mu):
        """Try mu / nu, then mu, then mu * nu^k while the error does not
        fall below the linearization's and mu < max_mu; the blocks
        depend only on (po, pts): one assembly serves every trial."""
        po_sh = replicate(mesh, po)
        parts = [_local_assemble(s, p, x)
                 for s, p, x in zip(shards, po_sh, pts)]
        error0 = f32(_mean_error(mesh, [p[5] for p in parts]).item())
        # U and e_cam do not depend on mu: their psum serves every trial
        cam = psum(mesh, [torch.cat([U.reshape(-1), e.reshape(-1)])
                          for U, _, _, e, _, _ in parts])[0]
        U_sum = cam[:36 * M].reshape(M, 6, 6)
        e_cam_sum = cam[36 * M:]

        def try_mu(mu_):
            mu_ = float(mu_)
            V_inv = _inverses([V + mu_ * I3.to(V.device)
                               for _, V, _, _, _, _ in parts])
            contrib = [_schur_parts(W, Vi, e_pt) for (_, _, W, _, e_pt, _),
                       Vi in zip(parts, V_inv)]
            system = psum(mesh, [torch.cat([S.reshape(-1), rhs.reshape(-1)])
                                 for S, rhs in contrib])[0]
            S = system[:36 * M * M].reshape(6 * M, 6 * M)
            S = S + torch.block_diag(*(U_sum + mu_ * I6))
            rhs = e_cam_sum + system[36 * M * M:]
            dposes = solve(S, rhs).reshape(M, 6)
            new_pts = []
            for (_, _, W, _, e_pt, _), Vi, x, d in zip(
                    parts, V_inv, pts, replicate(mesh, dposes)):
                Wt_dc = sum_small(matmul_small(
                    W.transpose(-1, -2), d[None, :, :, None])[..., 0]
                    .transpose(1, 2))                      # (Nl, 3)
                new_pts.append(x + matmul_small(
                    Vi, (e_pt - Wt_dc)[..., None])[..., 0])
            new_po = po + dposes
            return new_po, new_pts, error_of(new_po, new_pts)

        po1, pts1, err1 = try_mu(mu / nu)
        if err1 < error0:
            return po1, pts1, mu / nu, err1
        po2, pts2, err2 = try_mu(mu)
        cur_mu, err = mu, err2
        while err >= error0 and cur_mu < max_mu:
            cur_mu = cur_mu * nu
            po2, pts2, err = try_mu(cur_mu)
        return po2, pts2, cur_mu, err

    mu = f32(initial_mu)
    cur_err = error_of(poses, points)
    for _ in range(max_iter):
        poses, points, mu, new_err = lm_update(poses, points, mu)
        rel = np.abs((cur_err - new_err) / np.maximum(new_err, f32(1e-30)))
        cur_err = new_err
        if new_err < abs_thr or rel < rel_thr:
            break
    return poses, points, cur_err


def distributed_lm_solve(mesh, poses, points, viewpoint_indices,
                         point_indices, x_true, max_iter=20,
                         initial_mu=1.0, nu=100.0,
                         absolute_error_threshold=1e-8,
                         relative_error_threshold=1e-6):
    """Landmark-sharded LM bundle adjustment over a device mesh.

    poses: (M, 6); points: (N, 3); observations indexed globally (array
    likes or tensors).  Returns (poses, points, error): tensors on this
    process's first shard's device, every process holding all N points.
    """
    def host(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                          else x)

    points = host(points).astype(np.float32)
    n_points = points.shape[0]
    n_devices = mesh.size
    vi_sh, pi_sh, x_sh, w_sh, pps = shard_observations(
        host(viewpoint_indices), host(point_indices), host(x_true),
        n_points, n_devices)
    points_pad = np.zeros((pps * n_devices, 3), dtype=np.float32)
    points_pad[:n_points] = points

    def up(a, device, dtype=None):
        return place(torch.from_numpy(np.ascontiguousarray(a, dtype)),
                     device)

    M = host(poses).shape[0]
    shards, blocks = [], []
    for i, device in zip(mesh.local_shards, mesh.local_devices):
        shards.append(_Shard(up(vi_sh[i], device, np.int64),
                             up(pi_sh[i], device, np.int64),
                             up(x_sh[i], device), up(w_sh[i], device), M,
                             pps))
        blocks.append(up(points_pad[i * pps:(i + 1) * pps], device))
    root = mesh.local_devices[0]
    poses = up(host(poses), root, np.float32)

    poses, blocks, err = _spmd_lm(
        mesh, shards, poses, blocks, max_iter, initial_mu, nu,
        absolute_error_threshold, relative_error_threshold)
    points = unshard(mesh, blocks, dim=0, device=root)[:n_points]
    return poses, points, torch.full((), float(err), device=root)
