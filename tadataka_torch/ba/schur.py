"""Schur-complement Levenberg-Marquardt bundle adjustment (counterpart of
``tadataka_tpu/ba/schur.py``).

The per-observation Jacobian blocks come from ``ba/residuals.py``; the
normal equations are summed into dense per-point blocks W (N, M, 6, 3);
the reduced camera system S (6M x 6M) is one contraction over the points.
The sums over observations take one order on every run (``_scatter_sum``):
the card's ``index_add_`` adds by atomics, in another order each run, and
the LM's strict tests at damping near 1e-8 turn such last bits into
different trials.
The LM schedule (mu / nu, then mu, then mu * nu^k up to ``max_mu``) runs
on the host: each trial reads one error from the device, and every test
is made in float32 as the JAX package's ``while_loop`` makes it.
"""

import numpy as np
import torch

from tadataka_torch.ba.residuals import (
    projection_residuals, projection_jacobians)
from tadataka_torch.core.rounding import fixed_order_sum
from tadataka_torch.core.solvers import inv, solve
from tadataka_torch.device import resolve_device


def _mean_squared_error(r, weights):
    return (torch.sum(torch.sum(r * r, dim=-1) * weights)
            / torch.clamp(torch.sum(weights), min=1.0))


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
    """How ``_scatter_sum`` sums on the card: the rows of U and e_cam
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


def _scatter_sum(values, index, n, positions):
    """Sums of values (O, ...) into n rows by index.  On the CPU,
    ``index_add_`` adds each row's terms one by one in observation order,
    as the JAX package's scatter does.  On the card each row's terms,
    gathered by ``positions`` (``_layout``), are summed pairwise by
    ``fixed_order_sum``: the same bits on every run."""
    if positions is None:
        return values.new_zeros((n,) + values.shape[1:]).index_add_(
            0, index, values)
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return fixed_order_sum(padded[positions].movedim(1, -1))


def _assemble(poses, points, viewpoint_indices, point_indices, x_true,
              weights, layout=None):
    """(U, V, W, e_cam, e_pt, error) of the current state.  ``layout``:
    ``_layout`` of the indices, made here on the card if not given."""
    M = poses.shape[0]
    N = points.shape[0]
    if layout is None and poses.device.type != "cpu":
        layout = _layout(viewpoint_indices, point_indices, M, N)
    by_view, by_point, by_pair = layout or (None, None, None)
    r = projection_residuals(poses, points, viewpoint_indices, point_indices,
                             x_true)                       # (O, 2)
    A, B = projection_jacobians(poses, points, viewpoint_indices,
                                point_indices)             # (O,2,6), (O,2,3)
    w = weights[:, None, None]
    Aw = A * w
    Bw = B * w
    U = _scatter_sum(torch.einsum('oia,oib->oab', Aw, A), viewpoint_indices,
                     M, by_view)
    V = _scatter_sum(torch.einsum('oia,oib->oab', Bw, B), point_indices, N,
                     by_point)
    W = _scatter_sum(torch.einsum('oia,oib->oab', Aw, B),
                     point_indices * M + viewpoint_indices, N * M,
                     by_pair).reshape(N, M, 6, 3)
    e_cam = _scatter_sum(torch.einsum('oia,oi->oa', Aw, r),
                         viewpoint_indices, M, by_view)
    e_pt = _scatter_sum(torch.einsum('oia,oi->oa', Bw, r), point_indices, N,
                        by_point)
    return U, V, W, e_cam, e_pt, _mean_squared_error(r, weights)


def _schur_step(U, V, W, e_cam, e_pt, mu):
    """Solve the damped normal equations through the Schur complement.
    Returns (dposes (M, 6), dpoints (N, 3))."""
    M = U.shape[0]
    I3 = torch.eye(3, dtype=V.dtype, device=V.device)
    I6 = torch.eye(6, dtype=U.dtype, device=U.device)
    V_inv = inv(V + mu * I3)                   # (N, 3, 3)
    Y = torch.einsum('nmab,nbc->nmac', W, V_inv)           # (N, M, 6, 3)
    # S_jk = delta_jk (U_j + mu I) - sum_n Y_nj W_nk^T
    S = -torch.einsum('njab,nkcb->jakc', Y, W).reshape(6 * M, 6 * M)
    S = S + torch.block_diag(*(U + mu * I6))
    rhs = (e_cam.reshape(-1)
           - torch.einsum('njab,nb->ja', Y, e_pt).reshape(-1))
    dposes = solve(S, rhs).reshape(M, 6)
    # back-substitute the points
    Wt_dc = torch.einsum('nmab,ma->nb', W, dposes)         # (N, 3)
    dpoints = torch.einsum('nab,nb->na', V_inv, e_pt - Wt_dc)
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
    layout = (None if poses.device.type == "cpu" else _layout(
        viewpoint_indices, point_indices, poses.shape[0], points.shape[0]))
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

        def try_mu(mu_):
            dpo, dpt = _schur_step(U, V, W, e_cam, e_pt, float(mu_))
            new_po, new_pt = po + dpo, pt + dpt
            return new_po, new_pt, f32(error_of(new_po, new_pt).item())

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
    return poses, points, torch.tensor(cur_err, device=poses.device)


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
