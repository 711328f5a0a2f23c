"""Plain forms of VITAMIN-E's front end, for the reference: the image
curvature and its extrema, the curvature hill climb, FAST-9 with BRIEF,
mutual-nearest matching with the ratio test, the fundamental-matrix
RANSAC, the homography filter and the affine flow by IRLS.

Written from the published methods (Yokozuka et al., CVPR 2019; Rosten
and Drummond, ECCV 2006; Calonder et al., ECCV 2010; Hartley's
normalized 8-point algorithm) and the JAX package's choices, each in
the most direct vectorised PyTorch on the tensors' device, float32:
stencils as sums of shifted slices (scipy's separable Sobel: the
difference, then the smoothing), reductions by ``torch.sum``,
factorizations by ``torch.linalg`` where the tensors are, quantiles by
``torch.quantile``.  Nothing here rounds in a fixed order, so the
program and this reference part by float32 roundings; where a rounding
decides a discrete choice (a threshold, an ``argmax``) they may part
further, and the check's limits say how far.

The JAX package's choices kept: scipy's Sobel with the edge sample
repeated; ``jnp.percentile``'s linear quantile and ``jnp.median``'s
midpoint; the strongest extrema first, the lower pixel index first
among equal values; the climb's 3x3 neighbourhood in row-major order,
the first maximum winning, 20 steps, Geman-McClure drift with sigma 3,
the parabola's 1e-12 guard and its clip to half a pixel; FAST on a
radius-3 Bresenham ring with an arc of 9 and a 3x3 non-maximum
suppression; BRIEF's 512 pairs drawn by ``np.random.default_rng(1)``
over a 64-pixel patch of the image blurred by a 5-tap Gaussian; 128
RANSAC trials, each sampling floor(u n) among the valid matches;
chi-squared at 0.95 with 2 degrees of freedom on ZCA-whitened transfer
errors; Huber weights at 1.345 with the MAD scale over 30 reweighted
fits.
"""

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = float(np.sqrt(np.float32(2.0)))
CHI2_95_DOF2 = 5.991464547107979
BIG = 1e9
RING = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
        (-1, -3)]
NEIGHBOURS = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


# ------------------------------------------------------------ stencils

def sobel(image, axis):
    """scipy.ndimage.sobel(image, axis, mode="reflect"): the central
    difference along ``axis``, then [1, 2, 1] across it; one pixel past
    the edge is the edge sample."""
    p = F.pad(image[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    if axis == 1:
        d = p[:, 2:] - p[:, :-2]
        return d[:-2] + 2.0 * d[1:-1] + d[2:]
    d = p[2:] - p[:-2]
    return d[:, :-2] + 2.0 * d[:, 1:-1] + d[:, 2:]


def curvature(image):
    """kappa = fy^2 fxx - fx fy fxy - fy fx fyx + fx^2 fyy."""
    fx, fy = sobel(image, 1), sobel(image, 0)
    return (fy * fy * sobel(fx, 1) - fx * fy * sobel(fx, 0)
            - fy * fx * sobel(fy, 1) + fx * fx * sobel(fy, 0))


def extrema(curv, percentile, max_keypoints):
    """The pixels above the curvature's percentile, strongest first:
    ([x, y] (K, 2), valid (K,))."""
    H, W = curv.shape
    threshold = torch.quantile(curv.reshape(-1), percentile / 100.0,
                               interpolation="linear")
    flat = torch.where(curv > threshold, curv, float("-inf")).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_keypoints], idx[:max_keypoints]
    return (torch.stack([(idx % W).float(), (idx // W).float()], -1),
            torch.isfinite(vals))


def in_image(xy, shape):
    H, W = shape
    return ((xy[..., 0] >= 0) & (xy[..., 0] <= W - 1)
            & (xy[..., 1] >= 0) & (xy[..., 1] <= H - 1))


def climb(curv, start, lambda_, steps=20, sigma2=9.0):
    """Each start [x, y] rounded, then moved to the best of its 3x3
    neighbourhood of curvature + lambda (1 - rho(drift)) until the
    centre wins, then a parabola's subpixel offset; starts outside the
    image keep their place."""
    H, W = curv.shape
    padded = F.pad(curv[None, None], (1, 1, 1, 1),
                   value=float("-inf"))[0, 0]
    rounded = torch.round(start)
    frac = start - rounded
    inside = in_image(rounded, (H, W))
    p0 = torch.where(inside[:, None], rounded, 0.0).long()
    nb = torch.tensor(NEIGHBOURS, device=curv.device)

    def patch(p):   # (K, 9) around p, in the padded frame
        q = p[:, None, :] + 1 + nb[None]
        return padded[q[..., 1], q[..., 0]]

    p = p0.clone()
    moving = torch.ones(len(p), dtype=torch.bool, device=curv.device)
    for _ in range(steps):
        drift = (p - p0)[:, None, :].float() + nb[None].float()
        u = (drift ** 2).sum(-1)
        energy = patch(p) + lambda_ * (1.0 - u / (u + sigma2))
        step = nb[torch.argmax(energy, dim=1)]
        centre = (step == 0).all(-1)
        moving = moving & ~centre
        p = p + step * moving[:, None]
    c = patch(p)

    def parabola(m, o, n):
        d = m - 2.0 * o + n
        off = 0.5 * (m - n) / torch.where(d.abs() < 1e-12, 1e-12, d)
        return torch.where(torch.isfinite(off), off, 0.0).clamp(-0.5, 0.5)
    offset = torch.stack([parabola(c[:, 3], c[:, 4], c[:, 5]),
                          parabola(c[:, 1], c[:, 4], c[:, 7])], -1)
    return torch.where(inside[:, None], p.float() + offset, rounded + frac)


# ------------------------------------------------------------ FAST / BRIEF

def fast(image, threshold, max_keypoints):
    """FAST-9 corners: (keypoints [x, y] (K, 2), valid (K,))."""
    H, W = image.shape
    padded = F.pad(image, (3, 3, 3, 3))
    ring = torch.stack([padded[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dx, dy in RING])
    brighter = ring > image + threshold
    darker = ring < image - threshold

    def arc(flags):
        found = torch.zeros_like(image, dtype=torch.bool)
        for s in range(16):
            found |= flags[[(s + j) % 16 for j in range(9)]].all(0)
        return found
    score = torch.clamp((ring - image).abs() - threshold, min=0.0).sum(0)
    ys = torch.arange(H, device=image.device)[:, None]
    xs = torch.arange(W, device=image.device)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    score = torch.where((arc(brighter) | arc(darker)) & interior, score, 0.0)
    peak = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    kept = torch.where(score >= peak, score, 0.0)
    vals, idx = torch.sort(kept.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:max_keypoints], idx[:max_keypoints]
    x = (idx % W).clamp(1, W - 2)
    y = (idx // W).clamp(1, H - 2)

    def parabola(m, o, n):
        d = m - 2.0 * o + n
        return (0.5 * (m - n) / torch.where(d.abs() < 1e-12, 1e-12, d)
                ).clamp(-0.5, 0.5)
    fx = x.float() + parabola(score[y, x - 1], score[y, x], score[y, x + 1])
    fy = y.float() + parabola(score[y - 1, x], score[y, x], score[y + 1, x])
    return torch.stack([fx, fy], -1), vals > 0.0


def blur5(image):
    """The 5-tap Gaussian (sigma 1) along rows, then columns, zero
    edges."""
    x = np.arange(-2, 3, dtype=np.float64)
    g = np.exp(-0.5 * x * x)
    g = (g / g.sum()).astype(np.float32)
    H, W = image.shape
    p = F.pad(image, (2, 2))
    rows = sum(float(g[4 - k]) * p[:, k:k + W] for k in range(5))
    p = F.pad(rows, (0, 0, 2, 2))
    return sum(float(g[4 - k]) * p[k:k + H] for k in range(5))


def brief_pattern(patch_size, n=512):
    rng = np.random.default_rng(1)
    half = patch_size // 2
    return (rng.integers(-(half - 2), half - 1, (n, 2)),
            rng.integers(-(half - 2), half - 1, (n, 2)))


def brief(image, keypoints, valid, patch_size):
    """+-1 descriptors (K, 512) and the keypoints whose patch fits."""
    H, W = image.shape
    smooth = blur5(image)
    half = patch_size // 2
    kx = torch.round(keypoints[:, 0]).long()
    ky = torch.round(keypoints[:, 1]).long()
    fits = (kx >= half) & (kx < W - half) & (ky >= half) & (ky < H - half)

    def sample(pos):
        pos = torch.as_tensor(pos, device=image.device)
        return smooth[(ky[:, None] + pos[None, :, 1]).clamp(0, H - 1),
                      (kx[:, None] + pos[None, :, 0]).clamp(0, W - 1)]
    pos0, pos1 = brief_pattern(patch_size)
    bits = torch.where(sample(pos0) < sample(pos1), 1.0, -1.0)
    return bits, valid & fits


def features(image, threshold, max_keypoints, patch_size):
    """(keypoints, descriptors, valid) of an image."""
    kps, valid = fast(image, threshold, max_keypoints)
    desc, valid = brief(image, kps, valid, patch_size)
    return kps, desc, valid


# ------------------------------------------------------------ matching

def match(desc1, valid1, desc2, valid2, max_ratio=0.8):
    """Mutual nearest neighbours by Hamming distance with the ratio test:
    (j of each row of set 1 (K1,), matched (K1,))."""
    D = desc1.shape[-1]
    dist = (D - desc1 @ desc2.T) * 0.5
    dist = torch.where(valid1[:, None] & valid2[None, :], dist, BIG)
    best = dist.argmin(1)
    best_d = dist.gather(1, best[:, None])[:, 0]
    rows = torch.arange(len(best), device=best.device)
    ok = valid1 & (best_d < BIG) & (dist.argmin(0)[best] == rows)
    second = dist.scatter(1, best[:, None], BIG).min(1).values
    second = torch.where(second == 0.0, torch.finfo(torch.float32).eps,
                         second)
    return best, ok & (best_d / second < max_ratio)


def sample_indices(r, mask):
    """floor(u n) into the valid positions (in index order)."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    n = mask.sum().clamp(min=1)
    idx = torch.floor(r * n).long().clamp(max=len(mask) - 1)
    return order[idx]


def hartley(points):
    """Points (..., n, 2) moved to mean 0 and mean distance sqrt(2):
    (normalized, T (..., 3, 3))."""
    mean = points.mean(-2, keepdim=True)
    centered = points - mean
    scale = SQRT2 / (centered.norm(dim=-1).mean(-1) + 1e-12)
    return centered * scale[..., None, None], similarity(scale, mean[..., 0, :])


def similarity(scale, mean):
    T = torch.zeros(scale.shape + (3, 3), dtype=scale.dtype,
                    device=scale.device)
    T[..., 0, 0] = T[..., 1, 1] = scale
    T[..., 0, 2] = -scale * mean[..., 0]
    T[..., 1, 2] = -scale * mean[..., 1]
    T[..., 2, 2] = 1.0
    return T


def epipolar_rows(x1, x2):
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], -1)


def null_vector(A):
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1]
                            )[2][..., -1, :]


def rank2(F_):
    U, s, Vh = torch.linalg.svd(F_)
    s = s.clone()
    s[..., 2] = 0.0
    return U @ torch.diag_embed(s) @ Vh


def eight_point(p1, p2):
    """Normalized 8-point fundamental matrices of (..., 8, 2) pairs with
    x2^T F x1 = 0, scaled to F[2, 2] = 1."""
    x1, T1 = hartley(p1)
    x2, T2 = hartley(p2)
    F_ = rank2(null_vector(epipolar_rows(x1, x2)).reshape(
        x1.shape[:-2] + (3, 3)))
    F_ = T2.transpose(-1, -2) @ F_ @ T1
    f22 = F_[..., 2:3, 2:3]
    return F_ / (f22 + torch.where(f22.abs() < 1e-12, 1e-12, 0.0))


def homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def sampson(F_, p1, p2):
    """The Sampson distances (..., N), squared."""
    x1, x2 = homogeneous(p1), homogeneous(p2)
    Fx1 = x1 @ F_.transpose(-1, -2)
    Ftx2 = x2 @ F_
    num = (x2 * Fx1).sum(-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / (den + 1e-12)


def ransac_fundamental(p1, p2, mask, draws, threshold):
    """The first trial's F with the most inliers and its inliers, from
    uniform ``draws`` (trials, 8)."""
    samples = sample_indices(draws, mask)
    Fs = eight_point(p1[samples], p2[samples])
    d = torch.sqrt(sampson(Fs, p1[None], p2[None]))
    best = (mask[None] & (d < threshold)).sum(-1).argmax()
    F_ = Fs[best]
    return F_, mask & (torch.sqrt(sampson(F_, p1, p2)) < threshold)


def masked_hartley(points, mask, eps):
    w = mask.float()
    n = w.sum().clamp(min=1.0)
    mean = (points * w[:, None]).sum(0) / n
    centered = points - mean
    scale = SQRT2 / ((centered.norm(dim=-1) * w).sum() / n + eps)
    return centered * scale, similarity(scale, mean)


def homography(p1, p2, mask):
    """The masked, normalized DLT homography p1 -> p2."""
    w = mask.float()[:, None]
    x1, T1 = masked_hartley(p1, mask, 1e-10)
    x2, T2 = masked_hartley(p2, mask, 1e-10)
    z, o = torch.zeros_like(x1[:, :1]), torch.ones_like(x1[:, :1])
    a = torch.cat([x1, o, z, z, z, -x2[:, :1] * x1, -x2[:, :1]], 1)
    b = torch.cat([z, z, z, x1, o, -x2[:, 1:] * x1, -x2[:, 1:]], 1)
    h = null_vector(torch.cat([a * w, b * w])).reshape(3, 3)
    H = torch.linalg.inv(T2) @ h @ T1
    return H / (H[2, 2] + 1e-10)


def transfer(H, p):
    q = homogeneous(p) @ H.T
    return q[:, :2] / (q[:, 2:] + 1e-10)


def chi2_inliers(X, mask):
    """Whitened squared residuals within chi2(0.95, 2)."""
    w = mask.float()[:, None]
    n = w.sum().clamp(min=1.0)
    mean = (X * w).sum(0) / n
    Xc = (X - mean) * w
    C = Xc.T @ Xc / (n - 1.0).clamp(min=1.0)
    U, s, _ = torch.linalg.svd(C)
    Z = U @ torch.diag(1.0 / (torch.sqrt(s) + 1e-10)) @ U.T
    Y = (X - mean) @ Z.T
    return (Y * Y).sum(-1) <= CHI2_95_DOF2


def homography_inliers(p1, p2, mask):
    H = homography(p1, p2, mask)
    return (chi2_inliers(transfer(H, p1) - p2, mask)
            & chi2_inliers(p1 - transfer(torch.linalg.inv(H), p2), mask)
            & mask)


def matched_pairs(features0, features1, draws, min_inliers=12):
    """Matching, then RANSAC on F and the homography filter where at
    least ``min_inliers`` matched: the matched keypoints (n, 2) of
    both frames."""
    kp0, desc0, valid0 = features0
    kp1, desc1, valid1 = features1
    best, ok = match(desc0, valid0, desc1, valid1)
    p1, p2 = kp0, kp1[best]
    if int(ok.sum()) >= min_inliers:
        _, inliers = ransac_fundamental(p1, p2, ok, draws, 1.0)
        ok = ok & inliers
        ok = ok & homography_inliers(p1, p2, ok)
    return p1[ok], p2[ok]


# ------------------------------------------------------------ the flow

def median(x):
    return torch.quantile(x, 0.5, dim=-1, interpolation="midpoint")


def irls_affine(p0, p1, iterations=30, huber=1.345, mad=0.6745,
                q=lambda x: x):
    """The affine map (3, 3) from p0 to p1, each row a Huber IRLS fit;
    ``q`` rounds each fit's normal equations (the control's)."""
    X = homogeneous(p0)
    y = p1.T                                           # (2, N)
    eye = 1e-10 * torch.eye(3, dtype=X.dtype, device=X.device)

    def fit(w):
        A = (X.T[None] * w[:, None, :]) @ X + eye      # (2, 3, 3)
        b = (X.T[None] * w[:, None, :]) @ y[..., None]
        return torch.linalg.solve(q(A), q(b))[..., 0]  # (2, 3)

    params = fit(torch.ones_like(y))
    for _ in range(iterations):
        r = y - params @ X.T
        scale = median((r - median(r)[:, None]).abs()) / mad
        z = (r / scale.clamp(min=1e-12)[:, None]).abs()
        w = torch.where(z <= huber, 1.0, huber / z.clamp(min=1e-12))
        w = torch.where((scale <= 0.0)[:, None], 1.0, w)
        params = fit(w)
    M = torch.eye(3, dtype=X.dtype, device=X.device)
    M[:2] = params
    return M


def apply_affine(M, p):
    return (homogeneous(p) @ M.T)[:, :2]
