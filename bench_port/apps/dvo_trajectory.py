"""Driver of a DvoTrajectory configuration: builds the app from the
configuration's file (the RadTan camera included), hands it each frame
as the host uint8 RGB image and float32 depth in metres, and names the
calls that the run times, counts and checks."""

import numpy as np
import torch

WARM_FRAMES = 6   # the first frame, the first tracked ones: every shape


class System:
    def __init__(self, config, loop, seed, device):
        from tadataka_torch.apps import DvoTrajectory
        from tadataka_torch.camera import CameraModel, CameraParameters
        from tadataka_torch.camera import NoDistortion, RadTan
        c = config["camera"]
        cm = CameraModel.create(
            CameraParameters.create((c["fx"], c["fy"]), (c["cx"], c["cy"])),
            NoDistortion() if c.get("radtan") is None
            else RadTan.create(c["radtan"]))
        self.vo = DvoTrajectory(cm, device=device, **config["app_args"])
        self.warm_frames = WARM_FRAMES

    def instrument(self, rec):
        import tadataka_torch.apps.dvo_trajectory as app
        import tadataka_torch.vo.dvo as dvo
        rec.wrap(app, "estimate_pose_pyramid", "track", span=True,
                 capture=True)
        rec.wrap(dvo, "_normal_equations", "normal_equations", count=True)

    def estimate(self, frame):
        return self.vo.estimate(frame)

    def snapshot(self):
        return self.vo.pose_wc

    @staticmethod
    def read_pose(pose):
        flat = torch.cat([pose.R.reshape(-1), pose.t]).cpu().numpy()
        T = np.eye(4)
        T[:3, :3] = flat[:9].reshape(3, 3)
        T[:3, 3] = flat[9:]
        return T

    @staticmethod
    def finite(pose):
        # the pose was read to the host and checked there
        return torch.ones((), dtype=torch.bool)

    def plan_mix(self, frames):
        return "no depth update"

    def release(self):
        self.vo = None

    def check(self, captures, loop, config, seed, device, err=None,
              control=False):
        from bench_port.reference import dvo_trajectory
        return dvo_trajectory.check(captures, loop, config, seed, device,
                                    err, control)
