#!/usr/bin/env python3
"""chip_smoke.py's stereo and euroc inputs through the JAX package and the
port, both on the CPU; prints each one's readings, from which the two
phases take their gates.

    JAX_PLATFORMS=cpu python tools/stereo_vs_jax.py

box: ``_box_filter`` of each package on seeded uniform [0, 1) stacks
(tests/test_torch_stereo.py's), each against the exact float64 moving
sum; small: that test's 64x128 pair at ``max_disparity=32``, the valid
masks' agreement and the largest sub-pixel difference.
stereo: phase 5's scene from the rectified pair of
``chip_smoke.stereo_pair`` (480x640, focal 480, 1.4 m), matched by
``estimate_depth_from_stereo`` at ``max_disparity=128``, ``radius=3``:
the valid share, the median |depth - GT| on valid pixels and how the
two valid masks and disparities agree.  euroc: the port's
``export_euroc_scene`` at 480x752 with 5 frames, read back by each
package's ``EurocDataset``, and stereo depth of frame 0 at
``max_disparity=64`` against ``debug_gt/0.npz``, as
tests/realdata/test_euroc_e2e.py computes it.  Needs the JAX package
(and so runs where the tests run, not on the card).  The last line is a
JSON object of the readings.
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tadataka_tpu.camera import CameraModel as JCameraModel  # noqa: E402
from tadataka_tpu.core.pose import Pose as JPose  # noqa: E402
from tadataka_tpu.dataset.synthetic import render_plane_scene  # noqa
from tadataka_tpu.vo import stereo as jstereo  # noqa: E402
from tadataka_tpu.camera import CameraParameters as JCameraParameters  # noqa
from tadataka_tpu.dataset.euroc import EurocDataset as JEurocDataset  # noqa
from tadataka_tpu.vo.stereo import (  # noqa: E402
    estimate_depth_from_stereo as jestimate)

import chip_smoke  # noqa: E402
from tadataka_torch.dataset import EurocDataset, export_euroc_scene  # noqa
from tadataka_torch.dataset.synthetic import MULTI_PLANES  # noqa: E402
from tadataka_torch.vo import stereo  # noqa: E402
from tadataka_torch.vo.stereo import estimate_depth_from_stereo  # noqa


def readings(depth, valid, gt):
    depth, valid = np.asarray(depth), np.asarray(valid)
    return dict(valid=float(valid.mean()),
                median_err=float(np.median(np.abs(depth - gt)[valid])))


def box_and_small():
    """The box filters against the exact sum, and the small pair."""
    x = np.random.default_rng(5).random((3, 24, 40), dtype=np.float32)
    exact = stereo._box_filter(torch.from_numpy(x.astype(np.float64)),
                               3).numpy()
    rel = lambda a: float(np.max(np.abs(a - exact) / exact))
    box = dict(port=rel(stereo._box_filter(torch.from_numpy(x), 3).numpy()),
               jax=rel(np.asarray(jstereo._box_filter(jnp.asarray(x), 3))))
    cam = JCameraModel.create(JCameraParameters.create((64.0, 64.0),
                                                       (64.0, 32.0)))
    left, right = (np.array(render_plane_scene(
        cam, pose, (64, 128), planes=MULTI_PLANES)[0]) for pose in (
        JPose.identity(), JPose(jnp.eye(3), jnp.float32([2.0, 0, 0]))))
    jd, jv = (np.asarray(a) for a in jstereo.match_stereo(
        jnp.asarray(left), jnp.asarray(right), max_disparity=32))
    pd, pv = (a.numpy() for a in stereo.match_stereo(
        torch.from_numpy(left), torch.from_numpy(right), max_disparity=32))
    both = jv & pv
    small = dict(valid_agree=float(np.mean(jv == pv)),
                 rounded_equal=float(np.mean(
                     (np.rint(jd) == np.rint(pd))[both])),
                 max_subpixel_diff=float(np.abs(jd - pd)[both].max()))
    return box, small


def main():
    out = {}
    out["box"], out["small"] = box_and_small()
    print("box (max relative error to the exact sum)", out["box"],
          flush=True)
    print("small", out["small"], flush=True)
    params, left, right, gt = chip_smoke.stereo_pair()
    jcam = JCameraParameters.create(params.focal_length.numpy(),
                                    params.offset.numpy())
    args = dict(max_disparity=chip_smoke.STEREO_MAX_DISPARITY,
                radius=chip_smoke.STEREO_RADIUS)
    jd, jv = jestimate(jcam, left.numpy(), right.numpy(),
                       chip_smoke.STEREO_BASELINE, **args)
    pd, pv = estimate_depth_from_stereo(params, left, right,
                                        chip_smoke.STEREO_BASELINE,
                                        device="cpu", **args)
    jv, pv = np.asarray(jv), pv.numpy()
    out["stereo"] = dict(jax=readings(jd, jv, gt.numpy()),
                         port=readings(pd, pv, gt.numpy()),
                         valid_agree=float(np.mean(jv == pv)))
    print("stereo", out["stereo"], flush=True)

    with tempfile.TemporaryDirectory() as root:
        export_euroc_scene(root, n_frames=chip_smoke.N_EUROC_FRAMES,
                           image_shape=chip_smoke.EUROC_SHAPE)
        gt = np.load(Path(root, "debug_gt", "0.npz"))["depth"]
        f0, f1 = EurocDataset(root)[0]
        g0, g1, baseline = chip_smoke.euroc_stereo(f0, f1)
        pd, pv = estimate_depth_from_stereo(
            f0.camera_model.camera_parameters, g0, g1, baseline,
            max_disparity=chip_smoke.EUROC_MAX_DISPARITY, device="cpu")
        j0, j1 = JEurocDataset(root)[0]
        jbaseline = float(np.linalg.norm(np.asarray(j1.pose.t)
                                         - np.asarray(j0.pose.t)))
        jd, jv = jestimate(
            j0.camera_model.camera_parameters,
            jnp.asarray(j0.image, jnp.float32) / 255.0,
            jnp.asarray(j1.image, jnp.float32) / 255.0, jbaseline,
            max_disparity=chip_smoke.EUROC_MAX_DISPARITY)
        out["euroc"] = dict(jax=readings(jd, jv, gt),
                            port=readings(pd, pv.numpy(), gt),
                            baseline=dict(jax=jbaseline, port=baseline))
    print("euroc", out["euroc"], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
