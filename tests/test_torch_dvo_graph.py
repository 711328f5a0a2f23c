"""DVO's Gauss-Newton iterations replayed as CUDA graphs (``vo/dvo.py``'s
``_LevelGraph``) against the same iteration body run eagerly on the card
and on the CPU.

This file imports no JAX, so it runs on a machine with a card without
``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest tests/test_torch_dvo_graph.py -m cuda

Without a CUDA device the tests skip (a CUDA graph has no CPU form).
"""

import warnings

import pytest
import torch

import tadataka_torch.vo.dvo as dvo
from tadataka_torch.camera import CameraModel, CameraParameters, RadTan
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset.synthetic import render_plane_scene
from tadataka_torch.utils.timing import trace

SHAPE = (120, 160)
N_LEVELS = 4
PLANES = [((0.0, 0.0, 2.5), (0.06, -0.04, -1.0)),
          ((0.8, 0.0, 3.5), (-0.3, 0.0, -1.0))]
WEIGHT_KINDS = ["map", "huber", "none", "depth-var", "tukey", "student-t"]


def card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU form")
    return torch.device("cuda")


def scene(distortion, step=1.0):
    """A camera (pinhole or freiburg1's RadTan), two frames of two tilted
    planes ``step`` times a small motion apart, and a positive map (the
    weights of "map", the inverse-depth variance of "depth-var")."""
    cm = CameraModel.create(
        CameraParameters.create((120.0, 120.0), (79.5, 59.5)),
        RadTan.create([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
        if distortion == "radtan" else None)
    poses = [Pose.identity(),
             Pose.from_rotvec(torch.tensor([0.0, 0.01, 0.003]) * step,
                              torch.tensor([0.05, 0.02, 0.03]) * step)]
    (I0, D0), (I1, _) = [render_plane_scene(cm, pose, SHAPE, planes=PLANES)
                         for pose in poses]
    gen = torch.Generator().manual_seed(7)
    return cm, (I0, D0, I1, 1.0 / (0.01 + torch.rand(SHAPE, generator=gen)))


def prepare(cm, images, device):
    """The camera, its cached grids and the images on ``device``."""
    cm = cm.to(device)
    return (cm, dvo.normalized_grids(cm, N_LEVELS, 1.5, SHAPE),
            [x.to(device) for x in images])


def pyramid(prepared, kind, method):
    """The pose (on the host) and the trace's counts of one pyramid
    call on ``prepare``'s inputs."""
    cm, grids, (I0, D0, I1, wmap) = prepared
    device = I0.device
    with trace() as t:
        R, tr = dvo.estimate_pose_pyramid(
            cm, cm, I0, D0, I1, wmap, torch.eye(3, device=device),
            torch.zeros(3, device=device), N_LEVELS, 20, 1.5, kind, method,
            grids)
    counts = {k: v.get(None, 0) for k, v in t.counts.items()}
    return R.cpu(), tr.cpu(), counts


def eager_on(device):
    """``_level_iteration`` without the graph: the body run eagerly on
    ``device``'s tensors."""
    def level_iteration(body, inputs, method, weight_kind, pose_dtype):
        return lambda R, t: body(R.to(device), t.to(device), **inputs)
    return level_iteration


@pytest.mark.cuda
@pytest.mark.parametrize("distortion", ["pinhole", "radtan"])
@pytest.mark.parametrize("method", ["ic", "fc"])
@pytest.mark.parametrize("kind", WEIGHT_KINDS)
def test_graph_replay_matches_the_eager_body(monkeypatch, kind, method,
                                             distortion):
    """The pyramid through the level graphs, the same body run eagerly on
    the card, and the CPU: the same pose bits and the same iterations,
    every iteration a replay."""
    card = card_or_skip()
    cm, images = scene(distortion)
    on_card = prepare(cm, images, card)
    R, t, counts = pyramid(on_card, kind, method)
    assert counts["dvo.graph_replay"] == counts["dvo.gn_iter"] > N_LEVELS
    cpu = pyramid(prepare(cm, images, "cpu"), kind, method)
    monkeypatch.setattr(dvo, "_level_iteration", eager_on(card))
    eager = pyramid(on_card, kind, method)
    for other in (eager, cpu):
        assert torch.equal(R, other[0]) and torch.equal(t, other[1])
        assert counts["dvo.gn_iter"] == other[2]["dvo.gn_iter"]
        assert "dvo.graph_replay" not in other[2]


@pytest.mark.cuda
def test_a_level_captures_once_a_stream(monkeypatch):
    """With no graph kept, the first call captures one graph a level and
    a second frame of the same shape none; another stream gets graphs of
    its own, with the same bits."""
    card = card_or_skip()
    monkeypatch.setattr(dvo, "_graphs", {})
    cm, images = scene("pinhole")
    _, frame2 = scene("pinhole", step=2.0)
    first = pyramid(prepare(cm, images, card), "map", "ic")
    second = pyramid(prepare(cm, frame2, card), "map", "ic")
    assert first[2]["dvo.graph_capture"] == N_LEVELS
    assert "dvo.graph_capture" not in second[2]
    for _, _, counts in (first, second):
        assert counts["dvo.graph_replay"] == counts["dvo.gn_iter"]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        again = pyramid(prepare(cm, frame2, card), "map", "ic")
    torch.cuda.current_stream(card).wait_stream(side)
    assert again[2]["dvo.graph_capture"] == N_LEVELS
    assert len(dvo._graphs) == 2 * N_LEVELS
    assert torch.equal(again[0], second[0])
    assert torch.equal(again[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("distortion,kind", [
    ("pinhole", "map"), ("radtan", "huber"), ("pinhole", "tukey")])
def test_one_host_sync_an_iteration(distortion, kind):
    """Under ``set_sync_debug_mode("warn")``, a call whose graphs exist
    synchronizes the host once an iteration (the sums) and six times a
    level (the pose's fetch, the best pose's upload, the upper-triangle
    index): the count of the ``sync.*`` marks."""
    card = card_or_skip()
    cm, images = scene(distortion)
    cm, grids, (I0, D0, I1, wmap) = prepare(cm, images, card)
    eye, zero = torch.eye(3, device=card), torch.zeros(3, device=card)

    def call():
        return dvo.estimate_pose_pyramid(cm, cm, I0, D0, I1, wmap, eye,
                                         zero, N_LEVELS, 20, 1.5, kind,
                                         "ic", grids)
    call()
    torch.cuda.synchronize()
    with trace() as t, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = {k: v[None] for k, v in t.counts.items()}
    # the program's syncs: switching the mode back warns from torch's own
    # frame
    syncs = sum("synchroniz" in str(w.message)
                and "tadataka_torch" in w.filename for w in caught)
    assert counts["sync.dvo.sums"] == counts["dvo.gn_iter"]
    assert syncs == counts["dvo.gn_iter"] + 6 * N_LEVELS
    assert syncs == sum(n for name, n in counts.items()
                        if name.startswith("sync."))
