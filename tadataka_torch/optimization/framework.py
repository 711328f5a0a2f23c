"""Generic nonlinear least-squares mini-framework (counterpart of
``tadataka_tpu/optimization/framework.py``).

Function / Residual / Error / Robustifier / GaussNewtonUpdater /
Optimizer, as in the reference's ``optimization/``.  Jacobians come from
``torch.func.jacfwd``, robustifier gradients from ``torch.func.grad``
under ``vmap``, and the least-squares step from the host's LAPACK
(``core/solvers.py::solve_lstsq``).  The optimizer is a host loop.

This module is standalone (the VO paths use their dedicated solvers).
"""

import torch

from tadataka_torch.core.solvers import solve_lstsq


class Function:
    def compute(self, x):
        raise NotImplementedError()


class BaseResidual(Function):
    """r(theta) = y - f(theta)."""

    def __init__(self, y, transformer):
        self.y = y
        self.transformer = transformer

    def compute(self, theta):
        return self.y - self.transformer.compute(theta)


class BaseRobustifier:
    def robustify(self, x):
        raise NotImplementedError()

    def grad(self, x):
        return torch.func.vmap(torch.func.grad(self.robustify))(x)

    def weights(self, x):
        """rho'(x) / x with a zero-safe guard."""
        g = self.grad(x)
        safe = torch.where(x == 0, 1.0, x)
        return torch.where(x == 0, 0.0, g / safe)


class SquaredRobustifier(BaseRobustifier):
    def robustify(self, x):
        return x ** 2


class GemanMcClureRobustifier(BaseRobustifier):
    def __init__(self, sigma=0.1):
        self.v = sigma ** 2

    def robustify(self, x):
        u = x ** 2
        return u / (u + self.v)


class SumRobustifiedNormError(Function):
    def __init__(self, robustifier):
        self.robustifier = robustifier

    def compute(self, residuals):
        norms = torch.linalg.norm(torch.atleast_2d(residuals), dim=1)
        return torch.sum(torch.func.vmap(self.robustifier.robustify)(norms))


class GaussNewtonUpdater:
    """delta = lstsq(J, r) with the Jacobian from ``torch.func.jacfwd``
    (the reference used autograd, updaters.py:7-37)."""

    def __init__(self, residual, robustifier=None):
        self.residual = residual
        self.robustifier = robustifier

    def flattened_residual(self, theta):
        return torch.ravel(self.residual.compute(theta))

    def jacobian(self, theta):
        return torch.func.jacfwd(self.flattened_residual)(theta)

    def compute(self, theta):
        r = self.flattened_residual(theta)
        J = self.jacobian(theta).reshape(r.shape[0], theta.shape[0])
        return solve_lstsq(J, r)


class Optimizer:
    """Error-decrease descent loop (optimizers.py:21-39), without the
    per-iteration prints."""

    def __init__(self, updater, residual, error):
        self.updater = updater
        self.residual = residual
        self.error = error

    def calc_error(self, theta):
        return self.error.compute(self.residual.compute(theta))

    def optimize(self, initial_theta, max_iter=200):
        theta = initial_theta
        last_error = float("inf")
        for _ in range(max_iter):
            d = self.updater.compute(theta)
            current_error = float(self.calc_error(theta))
            if current_error >= last_error:
                return theta
            theta = theta - d
            last_error = current_error
        return theta
