"""Lens distortion models (counterpart of
``tadataka_tpu/camera/distortion.py``): none, FOV (Devernay-Faugeras)
and radial-tangential in COLMAP's coefficient order.

Each model has a packed form on (..., 2) points and a componentwise
form on separate x and y tensors; they round as the JAX package's two
forms do.  The coefficients are tensors, so every branch is a select
and nothing syncs with the host, except the RadTan Newton undistort,
which reads "all lanes converged" on the host every
``_CONVERGENCE_CHECK`` iterations.  FOV goes through
``core.rounding``'s ``tan`` and ``atan`` and RadTan through products,
sums and true divisions, so both give the same bits on the CPU and the
card.
"""

from typing import NamedTuple

import torch

from tadataka_torch.core.rounding import as_divisor, atan, sqrt, tan
from tadataka_torch.utils.timing import sync_point

_R_EPS = 1e-8
# iterations of the Newton undistort between two host reads of "all
# converged"; iterations past convergence change no bit (converged lanes
# are frozen), so the check only bounds the wasted work
_CONVERGENCE_CHECK = 8


class NoDistortion(NamedTuple):
    def distort(self, x):
        return x

    def undistort(self, x):
        return x

    def distort_xy(self, u, v):
        return u, v

    def undistort_xy(self, u, v):
        return u, v

    @property
    def params(self):
        return []


def _norm(u, v):
    return sqrt(u * u + v * v)


class FOV(NamedTuple):
    """One-parameter FOV distortion (Devernay & Faugeras 1995)."""
    omega: torch.Tensor     # 0-d

    @classmethod
    def create(cls, omega, dtype=torch.float32, device="cpu"):
        return cls(torch.as_tensor(omega, dtype=dtype, device=device))

    def _bypass(self):
        """omega ~ 0 (``jnp.isclose(omega, 0)``): no distortion."""
        return torch.abs(self.omega) <= 1e-8

    def _factor(self, r, distort):
        omega = self.omega
        tan_half = tan(omega / as_divisor(2.0, omega))
        small_r = torch.abs(r) < _R_EPS
        safe_r = torch.where(small_r, 1.0, r)
        if distort:
            factor = torch.where(
                small_r, 2.0 * tan_half / omega,        # lim r -> 0
                atan(2.0 * safe_r * tan_half) / (omega * safe_r))
        else:
            factor = torch.where(
                small_r, omega / (2.0 * tan_half),
                tan(safe_r * omega) / (2.0 * safe_r * tan_half))
        return torch.where(self._bypass(), 1.0, factor)

    def distort(self, x):
        return self._factor(_norm(x[..., 0], x[..., 1]), True)[..., None] * x

    def undistort(self, x):
        return self._factor(_norm(x[..., 0], x[..., 1]), False)[..., None] * x

    def distort_xy(self, u, v):
        factor = self._factor(_norm(u, v), True)
        return factor * u, factor * v

    def undistort_xy(self, u, v):
        factor = self._factor(_norm(u, v), False)
        return factor * u, factor * v

    @classmethod
    def from_params(cls, params):
        if len(params) != 1:
            raise ValueError(f"FOV takes one parameter, got {len(params)}")
        return cls.create(params[0])

    @property
    def params(self):
        return [float(self.omega)]


class RadTan(NamedTuple):
    """Radial-tangential distortion, COLMAP coefficient order
    (k1, k2, p1, p2, k3)."""
    dist_coeffs: torch.Tensor   # (5,)

    @classmethod
    def create(cls, dist_coeffs, dtype=torch.float32, device="cpu"):
        """Coefficients padded with zeros to five."""
        c = torch.as_tensor(dist_coeffs, dtype=dtype, device=device)
        return cls(torch.cat([c, torch.zeros(5 - c.shape[0], dtype=dtype,
                                             device=device)]))

    def _coeffs(self):
        c = self.dist_coeffs
        return c[0], c[1], c[2], c[3], c[4]

    def distort(self, x):
        """Packed form: k3 multiplies r^6 = r^4 r^2, as the JAX package's
        per-point function rounds it."""
        k1, k2, p1, p2, k3 = self._coeffs()
        u, v = x[..., 0], x[..., 1]
        u2, v2, uv = u * u, v * v, u * v
        r2 = u2 + v2
        r4 = r2 * r2
        r6 = r4 * r2
        kr = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
        return torch.stack([
            u * kr + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2),
            v * kr + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)], dim=-1)

    def undistort(self, x, max_iter=100, threshold=1e-10):
        u, v = self.undistort_xy(x[..., 0], x[..., 1], max_iter=max_iter,
                                 threshold=threshold)
        return torch.stack([u, v], dim=-1)

    def distort_xy(self, u, v):
        """Componentwise form: k3 r^4 r^2 rounds as (k3 r^4) r^2."""
        k1, k2, p1, p2, k3 = self._coeffs()
        u2, v2, uv = u * u, v * v, u * v
        r2 = u2 + v2
        r4 = r2 * r2
        kr = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
        return (u * kr + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2),
                v * kr + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2))

    def _newton_step(self, u, v, pu, pv):
        """The Newton step toward distort(pu, pv) = (u, v), with the
        analytic 2x2 Jacobian of the distortion."""
        k1, k2, p1, p2, k3 = self._coeffs()
        u2, v2, uv = pu * pu, pv * pv, pu * pv
        r2 = u2 + v2
        r4 = r2 * r2
        kr = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
        du = pu * kr + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
        dv = pv * kr + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
        dkr = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
        j00 = kr + 2.0 * u2 * dkr + 2.0 * p1 * pv + 6.0 * p2 * pu
        j11 = kr + 2.0 * v2 * dkr + 2.0 * p2 * pu + 6.0 * p1 * pv
        j01 = 2.0 * uv * dkr + 2.0 * p1 * pu + 2.0 * p2 * pv
        rx = u - du
        ry = v - dv
        det = j00 * j11 - j01 * j01
        return (j11 * rx - j01 * ry) / det, (j00 * ry - j01 * rx) / det

    def undistort_xy(self, u, v, max_iter=100, threshold=1e-10):
        """Batched Newton undistort from (u, v): a lane freezes once its
        step's squared length falls below ``threshold``; the loop ends
        when every lane has, or after ``max_iter`` steps."""
        pu, pv = u, v
        active = torch.ones(u.shape, dtype=torch.bool, device=u.device)
        for i in range(max_iter):
            if i % _CONVERGENCE_CHECK == 0:
                with sync_point("sync.distortion.converged"):
                    done = not bool(active.any())
                if done:
                    break
            su, sv = self._newton_step(u, v, pu, pv)
            pu = torch.where(active, pu + su, pu)
            pv = torch.where(active, pv + sv, pv)
            active = active & (su * su + sv * sv >= threshold)
        return pu, pv

    @classmethod
    def from_params(cls, params):
        return cls.create(params)

    @property
    def params(self):
        return [float(v) for v in self.dist_coeffs]
