"""Driver of a SemiDenseVO configuration: builds the app from the
configuration's file, hands it each frame as a host uint8 RGB array,
bootstraps the second frame with the true relative pose, and names the
calls that the run times, counts and checks.  The planner's inputs
(the predicted keyframe pose and the refframes' poses, as the host
holds them) are kept on every frame, so that the check can plan each
sampled frame again."""

from collections import Counter

import numpy as np
import torch

WARM_AFTER_HISTORY = 4   # warm-up frames once the refframe history is full


class System:
    def __init__(self, config, loop, seed, device):
        from tadataka_torch.apps import SemiDenseVO
        from tadataka_torch.camera import CameraParameters
        from tadataka_torch.core.pose import Pose
        from tadataka_torch.vo.semi_dense import SemiDenseParams
        c, p = config["camera"], config["params"]
        args = dict(config["app_args"])
        args["depth_range"] = tuple(args["depth_range"])
        self.plans = {}
        self.vo = SemiDenseVO(
            CameraParameters.create((c["fx"], c["fy"]), (c["cx"], c["cy"])),
            params=SemiDenseParams.create(
                p["min_depth"], p["max_depth"],
                ref_step_size=p["ref_step_size"],
                min_gradient=p["min_gradient"], device=device),
            metrics=self, device=device, seed=seed, **args)
        T10 = np.linalg.inv(loop.frame(1).pose) @ loop.frame(0).pose
        pose10 = Pose(torch.tensor(T10[:3, :3], dtype=torch.float32),
                      torch.tensor(T10[:3, 3], dtype=torch.float32))
        self.vo.initial_pose_fn = lambda image0, image1: pose10
        self.cache_sizes = {}
        self.plan_inputs = {}    # frame -> (keyframe pose, refframe poses)
        # the initial frame, the bootstrap, the history filled, and a
        # few frames at the history's full size: every shape the window
        # runs
        self.warm_frames = 2 + args["history_size"] + WARM_AFTER_HISTORY

    # the app's metrics hook: the planner's decision of every frame
    def log_frame(self, frame_index, **values):
        self.plans[frame_index] = values
        cache = getattr(self.vo, "_plan_cache", None)
        if cache is not None:
            self.cache_sizes[frame_index] = len(cache)

    def instrument(self, rec):
        import tadataka_torch.apps.semi_dense_vo as app
        import tadataka_torch.vo.dvo as dvo
        import tadataka_torch.vo.semi_dense.sweep as sweep
        import tadataka_torch.vo.semi_dense.sweep_rect as sweep_rect
        rec.wrap(app, "track", "track", span=True, capture=True)
        rec.wrap(app, "propagate_step", "propagate", span=True, capture=True)
        rec.wrap(app, "update", "update", span=True, capture=True)
        rec.wrap(app, "regularize", "regularize", span=True, capture=True)
        rec.wrap(dvo, "_normal_equations", "normal_equations", count=True)
        rec.wrap(sweep, "ssd_search", "ssd_search", calls=True)
        rec.wrap(sweep_rect, "ssd_search", "ssd_search", calls=True)
        vo, real_plan = self.vo, self.vo._plan

        def plan(key_T_pred):
            self.plan_inputs[rec.frame] = (
                np.array(key_T_pred, np.float64),
                np.array(vo._ref_Ts_host, np.float64))
            return real_plan(key_T_pred)
        rec.wrap_callable(vo, "_plan", plan)

    def estimate(self, frame):
        return self.vo.estimate(frame.image)

    def snapshot(self):
        return self.vo.state

    @staticmethod
    def read_pose(state):
        flat = torch.cat([state.pose_wc.R.reshape(-1),
                          state.pose_wc.t]).cpu().numpy()
        T = np.eye(4)
        T[:3, :3] = flat[:9].reshape(3, 3)
        T[:3, 3] = flat[9:]
        return T

    @staticmethod
    def finite(state):
        return (torch.isfinite(state.depth_map).all()
                & torch.isfinite(state.variance_map).all())

    def plan_mix(self, frames):
        frames = [k for k in frames if k in self.plans]
        if not frames:
            return "none"
        paths = Counter(self.plans[k]["plan_path"] for k in frames)
        planes = np.mean([self.plans[k]["plan_n_planes"] for k in frames])
        mix = ", ".join(f"{p} {n} ({100 * n / len(frames):.1f}%)"
                        for p, n in paths.most_common())
        sizes = [self.cache_sizes[k] for k in frames if k in self.cache_sizes]
        misses = (f"; plan-cache misses a frame "
                  f"{(sizes[-1] - self.cache_sizes.get(frames[0] - 1, 0)) / len(frames):.3f}"
                  if sizes else "")
        return f"{mix}; planes a frame {planes:.1f}{misses}"

    def release(self):
        self.vo = None

    def check(self, captures, loop, config, seed, device, err=None,
              control=False):
        from bench_port.reference import semi_dense_vo
        return semi_dense_vo.check(captures, self.plan_inputs, loop, config,
                                   seed, device, err, control)
