"""The check that decides ``correct``, driven through the rest of a run
on the CPU at 120x160 (the harness's look for a card skipped): the
port's own CPU path passes against the reference; the control (the
reference held in bfloat16) fails; and a run whose timed path is broken
underneath comes out not correct, for each fault a cell can have: a
step that returns its state unchanged, and an answer altered where it
is produced; and, in the semi-dense cell, an update that leaves out
part of its work: a plan with fewer planes, a shorter refframe history
than the configuration's, no regularization, no fusion with the prior.
(One frame at a time on one device: no batch to halve and no exchange
between chips to leave out.)"""

import io

import pytest
import torch

from bench_port.harness import drive
from bench_port.tests.small import small

CELLS = ("sd-fr1-forward", "dvo-fr1-forward")
SEED = 2**31 + 101


def run(cell, seconds=1.5, control=False):
    err = io.StringIO()
    result = drive.run(cell, SEED, seconds, False, device="cpu",
                       config_override=small, control=control,
                       out=io.StringIO(), err=err)
    return result, err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_port_on_the_cpu_matches_the_reference(cell):
    result, err = run(cell)
    checks = result["checks"]
    # the port is bit-equal on CPU and card; the poses part by the
    # float32 composition alone
    assert checks.get("map_gap_pct", {"value": 0.0})["value"] == 0.0, err
    assert checks["pose_gap_mm"]["value"] < checks["pose_gap_mm"]["limit"]
    assert result["failed"] == 0 and result["correct"], err
    # every number compared is printed beside its limit, last
    assert list(result)[-1] == "checks"
    last = err.rstrip().splitlines()[-len(checks):]
    assert [line.split()[2].rstrip(":") for line in last] == list(checks)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    result, _ = run(cell, control=True)
    control, checks = result["control"], result["checks"]
    assert any(control[name] > checks[name]["limit"] for name in control)


def _unchanged_state(monkeypatch, cell):
    if cell.startswith("sd"):
        import tadataka_torch.apps.semi_dense_vo as app
        real = app.update

        def update(cam, params, image, T_wk, refs, age1, d1, v1, *rest):
            _, _, flags = real(cam, params, image, T_wk, refs, age1, d1, v1,
                               *rest)
            return d1, v1, flags          # the update leaves the map as is
        monkeypatch.setattr(app, "update", update)
    else:
        import tadataka_torch.apps.dvo_trajectory as app

        def pyramid(*args):
            return args[6], args[7]       # the pose change stays at its start
        monkeypatch.setattr(app, "estimate_pose_pyramid", pyramid)


def _altered_answer(monkeypatch, cell):
    if cell.startswith("sd"):
        import tadataka_torch.apps.semi_dense_vo as app
        real = app.track

        def track(*args):
            T10 = real(*args).clone()
            T10[0, 3] += 1e-3             # 1 mm along x
            return T10
        monkeypatch.setattr(app, "track", track)
    else:
        import tadataka_torch.apps.dvo_trajectory as app
        real = app.estimate_pose_pyramid

        def pyramid(*args):
            R, t = real(*args)
            return R, t + torch.tensor([1e-3, 0.0, 0.0])
        monkeypatch.setattr(app, "estimate_pose_pyramid", pyramid)


@pytest.mark.parametrize("fault", [_unchanged_state, _altered_answer],
                         ids=["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    result, err = run(cell)
    assert not result["correct"], err


def _fewer_planes(monkeypatch):
    import tadataka_torch.apps.semi_dense_vo as app
    real = app.plan_update_np

    def plan_update_np(*args):
        plan = real(*args)
        if plan.path != "tent":
            return plan
        return plan._replace(n_planes=tuple(max(16, n // 2)
                                            for n in plan.n_planes))
    monkeypatch.setattr(app, "plan_update_np", plan_update_np)


def _app_argument(name, value):
    def fault(monkeypatch):
        import tadataka_torch.apps.semi_dense_vo as app
        real = app.SemiDenseVO.__init__

        def init(self, *args, **kwargs):
            kwargs[name] = value
            real(self, *args, **kwargs)
        monkeypatch.setattr(app.SemiDenseVO, "__init__", init)
    return fault


@pytest.mark.parametrize(
    "fault", [_fewer_planes, _app_argument("history_size", 4),
              _app_argument("regularize_depth", False),
              _app_argument("fuse_prior", False)],
    ids=["fewer_planes", "shorter_history", "no_regularization",
         "no_prior_fusion"])
def test_an_update_that_does_less_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, err = run("sd-fr1-forward")
    assert not result["correct"], err
