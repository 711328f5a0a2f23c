"""Small dense linear solvers (counterpart of
``tadataka_tpu/core/solvers.py``).  Batched over leading dims.

Every factorization (SVD, symmetric eigendecomposition, LU solve,
inverse, determinant) runs on the host's LAPACK, whatever the device of
its input: a CUDA input is copied to the host in one copy, factorized
there and the result sent back through pinned memory without blocking
(one host synchronization a call).  cuSOLVER and LAPACK round apart, and
the host gives the CPU path's bits, so the feature VO gives the same
bits on the CPU and the card.  The matrices are small (3x3 to 9x9 and
the 6M x 6M reduced camera system of bundle adjustment), batched by
the caller into one call.  DVO solves its 6x6 system on the host for
the same reason (``vo/dvo.py``).
"""

import torch

from tadataka_torch.utils.timing import sync_point


def on_host(fn, *args):
    """fn(*args) with its tensor arguments on the host: CUDA float32
    tensors go down in one copy, fn's tensor results come back to their
    device through pinned memory without blocking.  CPU tensors run fn
    where they are."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device
    if device.type == "cpu":
        return fn(*args)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with sync_point("sync.solvers.on_host"):
        flat = flat.cpu()
    parts = iter(torch.split(flat, [t.numel() for t in tensors]))
    out = fn(*(next(parts).reshape(a.shape)
               if isinstance(a, torch.Tensor) else a for a in args))
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else list(out)
    back = torch.cat([o.reshape(-1).to(torch.float32) for o in outs])
    back = back.pin_memory().to(device, non_blocking=True)
    results = [b.reshape(o.shape).to(o.dtype) for b, o in zip(
        torch.split(back, [o.numel() for o in outs]), outs)]
    return results[0] if single else tuple(results)


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
    through the SVD: LAPACK's "gelsd", on the host)."""
    def lstsq(A, b):
        vector = b.ndim == A.ndim - 1
        x = torch.linalg.lstsq(A, b[..., None] if vector else b,
                               driver="gelsd").solution
        return x[..., 0] if vector else x
    return on_host(lstsq, A, b)


def nullspace_vector(A):
    """``solve_nullspace`` where A lies, for callers that compose it into
    one host call of their own."""
    _, _, vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return vh[..., -1, :]


def solve_nullspace(A):
    """x minimizing ||A x|| with ||x|| = 1: the last right singular vector
    of A (..., m, n).  The reduced SVD holds it where m >= n; a wide A
    needs the full V."""
    return on_host(nullspace_vector, A)


def svd(A):
    """torch.linalg.svd (reduced) on the host: (U, S, Vh)."""
    return on_host(lambda a: torch.linalg.svd(a, full_matrices=False), A)


def solve(A, B):
    """torch.linalg.solve without its error check, on the host: a singular
    system gives inf / NaN as in JAX."""
    return on_host(lambda a, b: torch.linalg.solve_ex(a, b)[0], A, B)


def inv(A):
    """torch.linalg.inv without its error check, on the host (see
    ``solve``)."""
    return on_host(lambda a: torch.linalg.inv_ex(a)[0], A)


def kabsch_rotation(S):
    """The proper rotation V diag(1, 1, det(V U^T)) U^T of the SVD S = U
    s V^T (..., 3, 3), on the host in one call."""
    def rotation(S):
        U, _, VT = torch.linalg.svd(S)
        V, Ut = VT.transpose(-1, -2), U.transpose(-1, -2)
        d = torch.sign(torch.linalg.det(V @ Ut))
        D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
        return (V * D[..., None, :]) @ Ut
    return on_host(rotation, S)
