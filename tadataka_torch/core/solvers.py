"""Small dense linear solvers (counterpart of
``tadataka_tpu/core/solvers.py``).  Batched over leading dims."""

import torch


def weighted_mean(x, w):
    return torch.sum(x * w) / torch.sum(w)


def solve_linear_equation(J, r, weights=None, damping=0.0):
    """argmin_x ||sqrt(W) (J x - r)||^2 by the normal equations.

    J: (N, d), r: (N,), weights: (N,) or None; ``damping`` adds
    damping * I.  Rows are masked by zero weights."""
    Jw = J if weights is None else J * weights[:, None]
    d = J.shape[1]
    JtJ = Jw.T @ J + damping * torch.eye(d, dtype=J.dtype, device=J.device)
    return solve(JtJ, Jw.T @ r)


def solve_lstsq(A, b):
    """Dense least squares with ``np.linalg.lstsq``'s answer (minimum norm
    through the SVD: "gelsd" on the CPU; the card's only driver, "gels",
    assumes full rank)."""
    driver = "gelsd" if A.device.type == "cpu" else None
    vector = b.ndim == A.ndim - 1
    x = torch.linalg.lstsq(A, b[..., None] if vector else b,
                           driver=driver).solution
    return x[..., 0] if vector else x


def solve_nullspace(A):
    """x minimizing ||A x|| with ||x|| = 1: the last right singular vector
    of A (..., m, n).  The reduced SVD holds it where m >= n; a wide A
    needs the full V."""
    _, _, vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return vh[..., -1, :]


def solve(A, B):
    """torch.linalg.solve without its error check: a singular system gives
    inf / NaN as in JAX, and the card is not synchronized to check."""
    return torch.linalg.solve_ex(A, B)[0]


def inv(A):
    """torch.linalg.inv without its error check (see ``solve``)."""
    return torch.linalg.inv_ex(A)[0]
