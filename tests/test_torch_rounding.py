"""The port's device-invariant arithmetic (``tadataka_torch/core/rounding.py``
and the fixed-order sums of ``vo/dvo.py`` and ``propagation.py``): each
helper against a numpy statement of the rounding it promises, and, on a
machine with a card, the CPU and the card giving the same bits.

This file imports no JAX, so it runs on a machine with a card without
``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest tests/test_torch_rounding.py -m cuda
"""

import numpy as np
import pytest
import torch

from tadataka_torch.core.rounding import (
    as_divisor, atan, atan2, cos, matmul_small, mean, norm, sin, sincos,
    sqrt, sqrt_positive, sum_small, tan)
from tadataka_torch.vo.dvo import _triangle_weights, fixed_order_sum
from tadataka_torch.vo.dvo import resize_image, resize_taps
from tadataka_torch.vo.semi_dense.propagation import scatter_add


@pytest.fixture
def gen():
    return np.random.default_rng(20261016)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 1e4])
def test_sqrt_is_correctly_rounded(gen, scale):
    """Equal to the float64 root rounded to float32 (the correctly rounded
    float32 root) on 200k inputs of each magnitude."""
    x = (gen.random(200_000) * scale).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(sqrt(torch.from_numpy(x)).numpy(), want)


def fov_arguments(gen, n=100_000):
    """The arguments FOV gives tan and atan (``camera/distortion.py``):
    omega / 2 for omega in (0, 3), r omega and 2 r tan(omega / 2) for a
    radius r up to 1.2 (past the normalized corner of a 640x480 image at
    a focal length of 500), with their negatives and 0."""
    omega = gen.uniform(0.0, 3.0, n)
    r = gen.uniform(0.0, 1.2, n)
    x = np.concatenate([omega / 2, r * omega, 2 * r * np.tan(omega / 2),
                        [0.0]]).astype(np.float32)
    return np.concatenate([x, -x])


def ulps_apart(a, b):
    """|a - b| in float32 ulps, for a and b of one sign."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("fn,ref", [(tan, np.tan), (atan, np.arctan)])
def test_tan_and_atan_on_the_fov_range(gen, fn, ref):
    """Equal to numpy's float64 function rounded to float32 on every
    input of the FOV range; odd, -0 kept, and exactly 0 at 0."""
    x = fov_arguments(gen)
    got = fn(torch.from_numpy(x)).numpy()
    want = ref(x.astype(np.float64)).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    half = len(x) // 2
    np.testing.assert_array_equal(got[half:], -got[:half])
    zeros = fn(torch.tensor([0.0, -0.0])).numpy()
    np.testing.assert_array_equal(zeros.view(np.int32),
                                  np.array([0.0, -0.0], np.float32)
                                  .view(np.int32))


@pytest.mark.parametrize("fn,ref", [(tan, np.tan), (atan, np.arctan)])
def test_tan_and_atan_off_the_fov_range(gen, fn, ref):
    """Within one ulp on |x| from 1e-30 to 1e4, and the special values:
    tan(+-inf) and tan(NaN) are NaN, atan(+-inf) is +-pi/2."""
    x = (gen.uniform(-1, 1, 100_000) * 10.0 ** gen.uniform(-30, 4, 100_000)
         ).astype(np.float32)
    got = fn(torch.from_numpy(x)).numpy()
    want = ref(x.astype(np.float64)).astype(np.float32)
    assert ulps_apart(got, want).max() <= 1
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = fn(special).numpy()
    assert np.isnan(out[2])
    if fn is atan:
        np.testing.assert_array_equal(out[:2], np.float32([np.pi / 2,
                                                           -np.pi / 2]))
    else:
        assert np.isnan(out[:2]).all()


def trig_arguments(gen, n=100_000):
    """Angles of |x| up to 1e4 over 40 orders of magnitude, rotation
    angles (|x| < 4), and the floats at and next to each quadrant change
    (x near k pi/4 for k up to 64), with their negatives and +-0."""
    wide = gen.uniform(-1, 1, n) * 10.0 ** gen.uniform(-30, 4, n)
    small = gen.uniform(-4, 4, n)
    edges = np.float32(np.arange(1, 65) * np.pi / 4)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                           np.nextafter(edges, np.float32(np.inf))])
    x = np.concatenate([wide, small, near, -near, [0.0]]).astype(np.float32)
    return np.concatenate([x, np.float32([-0.0])])


@pytest.mark.parametrize("fn,ref", [(sin, np.sin), (cos, np.cos)])
def test_sin_and_cos(gen, fn, ref):
    """Within one ulp of numpy's float64 function rounded to float32 on
    every argument (0 ulps on 99.99% of them); sin odd with -0 kept, cos
    even; sincos gives both at once with the same bits."""
    x = trig_arguments(gen)
    got = fn(torch.from_numpy(x)).numpy()
    want = ref(x.astype(np.float64)).astype(np.float32)
    assert got.dtype == np.float32
    d = ulps_apart(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-4
    flipped = fn(torch.from_numpy(-x)).numpy()
    np.testing.assert_array_equal(flipped, -got if fn is sin else got)
    assert sin(torch.tensor([-0.0])).numpy().view(np.int32)[0] == \
        np.float32(-0.0).view(np.int32)
    both = sincos(torch.from_numpy(x))
    assert torch.equal(both[0 if fn is sin else 1], fn(torch.from_numpy(x)))


def test_sin_and_cos_derivatives(gen):
    """Their forward-mode derivatives under ``vmap(jacfwd)`` within one
    float32 ulp of cos and -sin (float64, rounded); and of sqrt_positive
    within one ulp of 1 / (2 sqrt x), whose value is ``sqrt``'s."""
    x = torch.from_numpy(trig_arguments(gen)[:40_000])
    xd = x.numpy().astype(np.float64)
    for fn, want in ((sin, np.cos(xd)), (cos, -np.sin(xd))):
        got = torch.func.vmap(torch.func.jacfwd(fn))(x).numpy()
        assert ulps_apart(np.abs(got),
                          np.abs(want.astype(np.float32))).max() <= 1
    pos = torch.from_numpy((gen.random(20_000) * 100 + 1e-3)
                           .astype(np.float32))
    assert torch.equal(sqrt_positive(pos), sqrt(pos))
    got = torch.func.vmap(torch.func.jacfwd(sqrt_positive))(pos).numpy()
    want = (0.5 / np.sqrt(pos.numpy().astype(np.float64))).astype(np.float32)
    assert ulps_apart(got, want).max() <= 1


def test_atan2(gen):
    """Within one ulp of numpy's float64 arctan2 rounded to float32 in all
    four quadrants, on the axes and at |y| = |x|; IEEE's signed zeros."""
    n = 100_000
    y = (gen.normal(size=n) * 10.0 ** gen.uniform(-6, 6, n))
    x = (gen.normal(size=n) * 10.0 ** gen.uniform(-6, 6, n))
    y[:1000] = x[:1000] * gen.choice([-1, 1], 1000)
    y[1000:1100] = 0.0
    x[1100:1200] = 0.0
    y, x = y.astype(np.float32), x.astype(np.float32)
    got = atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.arctan2(y.astype(np.float64), x.astype(np.float64)).astype(
        np.float32)
    assert ulps_apart(np.abs(got), np.abs(want)).max() <= 1
    assert (np.sign(got) == np.sign(want)).all()
    zeros = torch.tensor([0.0, -0.0, 0.0, -0.0])
    xs = torch.tensor([1.0, 1.0, -1.0, -1.0])
    np.testing.assert_array_equal(
        atan2(zeros, xs).numpy(),
        np.arctan2(zeros.numpy(), xs.numpy()).astype(np.float32))


def test_small_sums_norms_and_means(gen):
    """sum_small and mean add left to right (mean divides truly); norm is
    sqrt of sum_small of the squares: numpy's statements, bit for bit."""
    x = gen.normal(size=(50, 5)).astype(np.float32)
    want = x[:, 0]
    for i in range(1, 5):
        want = want + x[:, i]
    np.testing.assert_array_equal(sum_small(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(mean(torch.from_numpy(x.T), 0).numpy(),
                                  want / np.float32(5))
    sq = x * x
    acc = sq[:, 0]
    for i in range(1, 5):
        acc = acc + sq[:, i]
    np.testing.assert_array_equal(norm(torch.from_numpy(x)).numpy(),
                                  np.sqrt(acc.astype(np.float64))
                                  .astype(np.float32))


def test_division_by_as_divisor_is_the_true_quotient():
    """u8 / 255 through ``as_divisor`` is numpy's float32 true quotient on
    every one of the 256 values."""
    x = torch.arange(256, dtype=torch.float32)
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    np.testing.assert_array_equal((x / as_divisor(255.0, x)).numpy(), want)


@pytest.mark.parametrize("shapes", [((3, 3), (3, 3)), ((4, 4), (4, 4)),
                                    ((7, 3), (3, 3)), ((2, 3, 3), (3, 1))])
def test_matmul_small_sums_left_to_right(gen, shapes):
    """Every product rounded to float32, then summed left to right in
    float32: numpy's statement of it, bit for bit."""
    a = gen.normal(size=shapes[0]).astype(np.float32)
    b = gen.normal(size=shapes[1]).astype(np.float32)
    want = a[..., :, 0:1] * b[..., 0:1, :]
    for i in range(1, a.shape[-1]):
        want = want + a[..., :, i:i + 1] * b[..., i:i + 1, :]
    got = matmul_small(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4800])
def test_fixed_order_sum_halves_pairwise(gen, n):
    """Zero-padded to a power of two and halved pairwise, in float32 —
    numpy's statement of it bit for bit — and within float32 rounding of
    the float64 sum."""
    x = gen.normal(size=(3, n)).astype(np.float32)
    want = np.pad(x, ((0, 0), (0, (1 << (n - 1).bit_length()) - n)))
    while want.shape[-1] > 1:
        half = want.shape[-1] // 2
        want = want[:, :half] + want[:, half:]
    got = fixed_order_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want[:, 0])
    np.testing.assert_allclose(got, x.astype(np.float64).sum(-1),
                               rtol=1e-5, atol=1e-4)


def test_scatter_add_sums_in_source_order(gen):
    """Each cell's terms added in source order, as a serial loop does;
    cells with one, two and many terms."""
    index = gen.integers(0, 50, 400)
    values = gen.normal(size=400).astype(np.float32)
    want = np.zeros(60, np.float32)
    for i, v in zip(index, values):
        want[i] = np.float32(want[i] + v)
    got = scatter_add(60, torch.from_numpy(index), torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sizes", [(480, 320), (480, 95), (640, 427),
                                   (80, 36), (100, 30)])
def test_resize_taps_hold_the_dense_weights(sizes):
    """The taps, scattered back, are the dense triangle weights exactly;
    each output sample's taps run in increasing input order."""
    n_in, n_out = sizes
    index, weight = resize_taps(n_in, n_out, "cpu")
    dense = torch.zeros((n_in, n_out))
    dense.scatter_add_(0, index, weight)
    assert torch.equal(dense, _triangle_weights(n_in, n_out))
    nonzero = weight != 0
    steps = torch.diff(index, dim=0)
    assert bool((steps[nonzero[1:]] > 0).all())


def test_resize_image_matches_the_dense_products(gen):
    """The tap sums against the two dense float64 products."""
    image = gen.random((48, 64)).astype(np.float32)
    wy = _triangle_weights(48, 32).double().numpy()
    wx = _triangle_weights(64, 43).double().numpy()
    got = resize_image(torch.from_numpy(image), (32, 43)).numpy()
    np.testing.assert_allclose(got, wy.T @ image @ wx, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_helpers_give_the_same_bits_on_the_card(gen):
    """sqrt, as_divisor, matmul_small, fixed_order_sum, scatter_add,
    resize_image, tan and atan (on 10^6 inputs: the FOV range and |x|
    from 1e-30 to 1e4), a FOV camera's normalize and unnormalize, sin
    and cos and their derivatives (angles over 40 orders of magnitude
    and the floats around each quadrant change up to 16 pi) and atan2:
    the card's result equals the CPU's bit for bit."""
    need_card()
    from tadataka_torch.camera import FOV, CameraModel, CameraParameters
    x = torch.from_numpy((gen.random(100_000) * 1e-2).astype(np.float32))
    wide = torch.from_numpy(np.concatenate([
        fov_arguments(gen, 250_000),
        (gen.uniform(-1, 1, 500_000) * 10.0 ** gen.uniform(-30, 4, 500_000)
         ).astype(np.float32)]))
    pixels = torch.from_numpy((gen.random((20_000, 2)) * [640.0, 480.0])
                              .astype(np.float32))
    angles = torch.from_numpy(trig_arguments(gen))

    def fov_camera(device):
        return CameraModel.create(CameraParameters.create(
            (517.3, 516.5), (318.6, 255.3), device=device),
            FOV.create(0.8, device=device))

    def fov_round_trip(us):
        camera = fov_camera(us.device)
        xs = camera.normalize(us)
        return torch.cat([xs, camera.unnormalize(xs)], -1)

    u8 = torch.arange(256, dtype=torch.float32)
    a = torch.from_numpy(gen.normal(size=(5, 4, 4)).astype(np.float32))
    index = torch.from_numpy(gen.integers(0, 500, 5000))
    values = torch.from_numpy(gen.normal(size=5000).astype(np.float32))
    image = torch.from_numpy(gen.random((480, 640)).astype(np.float32))
    cases = [
        (sqrt, (x,)),
        (lambda v: v / as_divisor(255.0, v), (u8,)),
        (matmul_small, (a, a)),
        (fixed_order_sum, (values.reshape(5, 1000),)),
        (lambda i, v: scatter_add(500, i, v), (index, values)),
        (lambda im: resize_image(im, (95, 127)), (image,)),
        (tan, (wide,)),
        (atan, (wide,)),
        (fov_round_trip, (pixels,)),
        (lambda v: torch.stack(sincos(v)), (angles,)),
        (atan2, (wide[:400_000], wide[400_000:800_000])),
        (lambda v: torch.func.vmap(torch.func.jacfwd(sin))(v), (angles,)),
        (lambda v: torch.func.vmap(torch.func.jacfwd(cos))(v), (angles,)),
    ]
    for fn, args in cases:
        cpu = fn(*args)
        card = fn(*(arg.cuda() for arg in args))
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_app_gives_the_same_bits_on_the_card():
    """Four 60x80 frames through SemiDenseVO on the CPU and on the card:
    the same poses and maps, bit for bit."""
    need_card()
    from tadataka_torch.apps import SemiDenseVO
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.core.pose import Pose
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.semi_dense import SemiDenseParams
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.02 * i]))
             for i in range(4)]
    ds = multi_plane_scene(4, (60, 80), (60.0, 60.0), poses)
    runs = []
    for device in ("cpu", "cuda"):
        vo = SemiDenseVO(
            CameraParameters.create((60.0, 60.0), (40.0, 30.0)),
            params=SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                          min_gradient=0.01),
            default_depth=8.0, default_variance=1.0, uncertainty_bias=0.01,
            depth_range=(2.0, 50.0), n_coarse_to_fine=3, history_size=3,
            device=device)
        vo.initial_pose_fn = lambda a, b: ds[1].pose.inv() * ds[0].pose
        runs.append([vo.estimate(ds[i]) for i in range(4)])
    for cpu, card in zip(*runs):
        for a, b in ((cpu.pose_wc.R, card.pose_wc.R),
                     (cpu.pose_wc.t, card.pose_wc.t),
                     (cpu.depth_map, card.depth_map),
                     (cpu.variance_map, card.variance_map)):
            assert torch.equal(a, b.cpu())
