"""Schur-complement Levenberg-Marquardt bundle adjustment (counterpart of
``tadataka_tpu/ba/schur.py``).

The per-observation Jacobian blocks come from ``ba/residuals.py``; the
normal equations are summed into dense per-point blocks W (N, M, 6, 3);
the reduced camera system S (6M x 6M) is one contraction over the points.
Every sum takes one order on both devices and every run: the sums over
observations add each row's terms one by one in observation order, the
JAX package's scatter order (``_scatter_sum``; the card's ``index_add_``
adds by atomics, in another order each run), the contractions over
points add pairwise, and the small products sum left to right
(``core/rounding.py``).  The 3x3 inverses and the reduced system's solve
run on the host (``core/solvers.py``).  The LM's strict tests at damping
near 1e-8 would turn any last-bit difference into a different trial.
The LM schedule (mu / nu, then mu, then mu * nu^k up to ``max_mu``) runs
on the host: each trial reads one error from the device, and every test
is made in float32 as the JAX package's ``while_loop`` makes it.
"""

import numpy as np
import torch

from tadataka_torch.ba.residuals import (
    projection_residuals, projection_jacobians)
from tadataka_torch.core.rounding import (
    fixed_order_sum, matmul_small, sum_small)
from tadataka_torch.core.solvers import inv, solve
from tadataka_torch.device import resolve_device
from tadataka_torch.utils.timing import probe


def _mean_squared_error(r, weights):
    sums = fixed_order_sum(torch.stack([sum_small(r * r) * weights,
                                        weights]))
    return sums[0] / torch.clamp(sums[1], min=1.0)


def _segments(index, counts, K):
    """(n, K) positions into the observations: each row's, in their order,
    padded with O (one past the last); ``counts`` (n,) the rows' sizes."""
    O = index.shape[0]
    order = torch.argsort(index, stable=True)
    start = torch.cumsum(counts, 0) - counts
    grouped = index[order]
    rank = torch.arange(O, device=index.device) - start[grouped]
    positions = torch.full((len(counts), K), O, dtype=torch.int64,
                           device=index.device)
    positions[grouped, rank] = order
    return positions


def _layout(viewpoint_indices, point_indices, M, N):
    """How ``_scatter_sum`` sums: the rows of U and e_cam
    (viewpoints), V and e_pt (points) and W (point-viewpoint pairs) as
    ``_segments``, from one host read of the largest row sizes (the
    sizes are counted by an integer scatter-add, exact in any order;
    ``torch.bincount`` would read its input's maximum on the host)."""
    groups = ((viewpoint_indices, M), (point_indices, N),
              (point_indices * M + viewpoint_indices, N * M))
    counts = [torch.zeros(n, dtype=torch.int64, device=i.device).index_add_(
        0, i, torch.ones_like(i)) for i, n in groups]
    K = torch.stack([c.max() for c in counts]).tolist()
    return tuple(_segments(i, c, max(k, 1))
                 for (i, _), c, k in zip(groups, counts, K))


def _scatter_sum(values, positions):
    """Sums of values (O, ...) into the rows of ``positions`` (``_layout``):
    each row's terms added one by one in observation order, from 0, as
    ``index_add_`` on the CPU and the JAX package's scatter add them;
    the same bits on every device and run (one add of all rows per
    position)."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    out = values.new_zeros((positions.shape[0],) + values.shape[1:])
    for k in range(positions.shape[1]):
        out = out + padded[positions[:, k]]
    return out


def _assemble(poses, points, viewpoint_indices, point_indices, x_true,
              weights, layout=None):
    """(U, V, W, e_cam, e_pt, error) of the current state.  ``layout``:
    ``_layout`` of the indices, made here if not given."""
    M = poses.shape[0]
    N = points.shape[0]
    if layout is None:
        layout = _layout(viewpoint_indices, point_indices, M, N)
    by_view, by_point, by_pair = layout
    r = projection_residuals(poses, points, viewpoint_indices, point_indices,
                             x_true)                       # (O, 2)
    A, B = projection_jacobians(poses, points, viewpoint_indices,
                                point_indices)             # (O,2,6), (O,2,3)
    w = weights[:, None, None]
    Awt = (A * w).transpose(1, 2)
    Bwt = (B * w).transpose(1, 2)
    O = r.shape[0]
    # the blocks that share a row layout are summed together
    cam = _scatter_sum(torch.cat([matmul_small(Awt, A).reshape(O, 36),
                                  matmul_small(Awt, r[..., None])[..., 0]],
                                 1), by_view)
    pt = _scatter_sum(torch.cat([matmul_small(Bwt, B).reshape(O, 9),
                                 matmul_small(Bwt, r[..., None])[..., 0]], 1),
                      by_point)
    W = _scatter_sum(matmul_small(Awt, B), by_pair).reshape(N, M, 6, 3)
    return (cam[:, :36].reshape(M, 6, 6), pt[:, :9].reshape(N, 3, 3), W,
            cam[:, 36:], pt[:, 9:], _mean_squared_error(r, weights))


def _schur_step(U, V, W, e_cam, e_pt, mu):
    """Solve the damped normal equations through the Schur complement.
    Returns (dposes (M, 6), dpoints (N, 3))."""
    M = U.shape[0]
    I3 = torch.eye(3, dtype=V.dtype, device=V.device)
    I6 = torch.eye(6, dtype=U.dtype, device=U.device)
    V_inv = inv(V + mu * I3)                   # (N, 3, 3)
    Y = matmul_small(W, V_inv[:, None])                    # (N, M, 6, 3)
    # S_jk = delta_jk (U_j + mu I) - sum_n Y_nj W_nk^T
    YW = matmul_small(Y[:, :, None], W[:, None].transpose(-1, -2))
    S = -fixed_order_sum(YW.permute(1, 3, 2, 4, 0)).reshape(6 * M, 6 * M)
    S = S + torch.block_diag(*(U + mu * I6))
    Ye = matmul_small(Y, e_pt[:, None, :, None])[..., 0]  # (N, M, 6)
    rhs = (e_cam - fixed_order_sum(Ye.permute(1, 2, 0))).reshape(-1)
    dposes = solve(S, rhs).reshape(M, 6)
    # back-substitute the points
    Wt_dc = sum_small(matmul_small(W.transpose(-1, -2),
                                   dposes[None, :, :, None])[..., 0]
                      .transpose(1, 2))                    # (N, 3)
    dpoints = matmul_small(V_inv, (e_pt - Wt_dc)[..., None])[..., 0]
    return dposes, dpoints


def lm_solve(poses, points, viewpoint_indices, point_indices, x_true,
             weights=None, max_iter=200, initial_mu=1.0, nu=100.0,
             absolute_error_threshold=1e-8, relative_error_threshold=1e-6,
             max_mu=1e12):
    """Levenberg-Marquardt with the mu / nu schedule.  Returns (poses,
    points, final_error) on the inputs' device; the host reads one error
    per damping trial."""
    if weights is None:
        weights = torch.ones(x_true.shape[0], dtype=x_true.dtype,
                             device=x_true.device)
    layout = _layout(viewpoint_indices, point_indices, poses.shape[0],
                     points.shape[0])
    f32 = np.float32
    nu, max_mu = f32(nu), f32(max_mu)
    abs_thr, rel_thr = f32(absolute_error_threshold), f32(
        relative_error_threshold)

    def error_of(po, pt):
        r = projection_residuals(po, pt, viewpoint_indices, point_indices,
                                 x_true)
        return _mean_squared_error(r, weights)

    def lm_update(po, pt, mu):
        """Try mu / nu, then mu, then mu * nu^k while the error does not
        fall below the linearization's and mu < max_mu.  The normal
        equations depend only on (po, pt): one assembly serves every
        trial."""
        U, V, W, e_cam, e_pt, error0 = _assemble(
            po, pt, viewpoint_indices, point_indices, x_true, weights,
            layout)
        error0 = f32(error0.item())
        probe("BA", U=U, V=V, W=W, e_cam=e_cam, e_pt=e_pt, error0=error0)

        def try_mu(mu_):
            dpo, dpt = _schur_step(U, V, W, e_cam, e_pt, float(mu_))
            new_po, new_pt = po + dpo, pt + dpt
            error = f32(error_of(new_po, new_pt).item())
            probe("BA", mu=mu_, dposes=dpo, dpoints=dpt, error=error,
                  accepted=error < error0)
            return new_po, new_pt, error

        po1, pt1, err1 = try_mu(mu / nu)
        if err1 < error0:
            return po1, pt1, mu / nu, err1
        po2, pt2, err2 = try_mu(mu)
        cur_mu, err = mu, err2
        while err >= error0 and cur_mu < max_mu:
            cur_mu = cur_mu * nu
            po2, pt2, err = try_mu(cur_mu)
        return po2, pt2, cur_mu, err

    mu = f32(initial_mu)
    cur_err = f32(error_of(poses, points).item())
    for _ in range(max_iter):
        poses, points, mu, new_err = lm_update(poses, points, mu)
        rel = np.abs((cur_err - new_err) / np.maximum(new_err, f32(1e-30)))
        cur_err = new_err
        if new_err < abs_thr or rel < rel_thr:
            break
    return poses, points, torch.full((), float(cur_err),
                                     device=poses.device)


class LocalBundleAdjustment:
    """Window BA over observations (viewpoint index, point index, x_true)
    on ``device`` (the card unless given)."""

    def __init__(self, viewpoint_indices, point_indices, x_true,
                 device="cuda"):
        assert len(viewpoint_indices) == x_true.shape[0]
        assert len(point_indices) == x_true.shape[0]
        self.device = resolve_device(device)
        self.viewpoint_indices = torch.as_tensor(
            np.asarray(viewpoint_indices), dtype=torch.int64).to(self.device)
        self.point_indices = torch.as_tensor(
            np.asarray(point_indices), dtype=torch.int64).to(self.device)
        self.x_true = torch.as_tensor(
            np.asarray(x_true), dtype=torch.float32).to(self.device)

    def compute(self, initial_rotvecs, initial_translations, initial_points,
                max_iter=200, initial_mu=1.0, nu=100.0,
                absolute_error_threshold=1e-8,
                relative_error_threshold=1e-6):
        def up(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(
                self.device)

        poses = torch.cat([up(initial_rotvecs), up(initial_translations)],
                          dim=-1)
        poses, points, _ = lm_solve(
            poses, up(initial_points), self.viewpoint_indices,
            self.point_indices, self.x_true, max_iter=max_iter,
            initial_mu=initial_mu, nu=nu,
            absolute_error_threshold=absolute_error_threshold,
            relative_error_threshold=relative_error_threshold)
        return poses[:, :3], poses[:, 3:], points
