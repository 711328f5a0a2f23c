"""The stereo matcher, the block-row update and the pipelined app on the
card against the same code on the CPU, bit for bit, and the pipelined
app's stream ordering.

This file imports no JAX, so it runs on a machine with a card without
``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda_slice.py -m cuda

Without a CUDA device the ``cuda`` tests skip.
"""

import numpy as np
import pytest
import torch

import tadataka_torch.apps.pipelined_semi_dense as pipelined
from tadataka_torch.apps import PipelinedSemiDenseVO
from tadataka_torch.camera import CameraModel, CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset import multi_plane_scene, render_plane_scene
from tadataka_torch.dataset.synthetic import MULTI_PLANES
from tadataka_torch.vo.semi_dense import (
    SemiDenseParams, make_frame, stack_frames, update_depth)
from tadataka_torch.vo.stereo import estimate_depth_from_stereo

H, W = 80, 100
FOCAL = 80.0
VO_ARGS = dict(default_depth=8.0, default_variance=1.0,
               uncertainty_bias=0.01, depth_range=(2.0, 50.0),
               n_coarse_to_fine=4, history_size=4)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def frames(n=5):
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.18 * i, 0.01 * i, 0.01 * i]))
             for i in range(n)]
    ds = multi_plane_scene(n, (H, W), (FOCAL, FOCAL), poses)
    return [ds[i] for i in range(n)]


def pipelined_states(device, sequence):
    """Every state of the pipelined app over the frames, and the flushed
    one, as CPU tensors."""
    boot = sequence[1].pose.inv() * sequence[0].pose
    vo = PipelinedSemiDenseVO(
        CameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2)),
        params=SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                      min_gradient=0.01),
        devices=(device, device), initial_pose_fn=lambda a, b: boot,
        **VO_ARGS)
    states = [vo.estimate(f) for f in sequence] + [vo.flush_map()]
    out = [[None if x is None else x.cpu()
            for x in (s.pose_wc.R, s.pose_wc.t, s.depth_map, s.variance_map,
                      s.age_map, s.flag_map)] for s in states]
    return out, vo


def assert_states_equal(a, b):
    for k, (sa, sb) in enumerate(zip(a, b)):
        for x, y in zip(sa, sb):
            assert (x is None and y is None) or torch.equal(x, y), k


@pytest.mark.cuda
def test_stereo_card_equals_cpu():
    """Disparity-based depth and the valid mask of a 96x160 pair at
    max_disparity 48 are bit-equal on the card and the CPU."""
    needs_card()
    params = CameraParameters.create((96.0, 96.0), (80.0, 48.0))
    cm = CameraModel.create(params)
    left, _ = render_plane_scene(cm, Pose.identity(), (96, 160),
                                 planes=MULTI_PLANES)
    right, _ = render_plane_scene(
        cm, Pose(torch.eye(3), torch.tensor([1.4, 0.0, 0.0])), (96, 160),
        planes=MULTI_PLANES)
    cpu = estimate_depth_from_stereo(params, left, right, 1.4,
                                     max_disparity=48, device="cpu")
    card = estimate_depth_from_stereo(params, left, right, 1.4,
                                      max_disparity=48)
    assert card[0].device.type == "cuda"
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    assert cpu[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 30), (30, 80)])
def test_update_depth_row_offset_card_equals_cpu(rows):
    """The scattered update of a block of rows, bit-equal on the card and
    the CPU."""
    needs_card()
    seq = frames(3)
    cam = CameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2))
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    gen = np.random.default_rng(3)
    gt = seq[2].depth_map.numpy()
    prior = torch.from_numpy(
        (gt * gen.uniform(0.9, 1.1, gt.shape)).astype(np.float32))
    variance = torch.from_numpy(
        gen.uniform(0.002, 0.05, gt.shape).astype(np.float32))
    age = torch.from_numpy(gen.integers(0, 3, gt.shape).astype(np.int32))
    a, b = rows
    out = []
    for device in ("cpu", "cuda"):
        to = lambda x: x.to(device)
        key = make_frame(CameraParameters(*map(to, cam)), to(seq[2].image),
                         to(seq[2].pose.T))
        refs = stack_frames([make_frame(CameraParameters(*map(to, cam)),
                                        to(f.image), to(f.pose.T))
                             for f in seq[:2]])
        out.append([x.cpu() for x in update_depth(
            key, refs, to(age[a:b]), to(prior[a:b]), to(variance[a:b]),
            SemiDenseParams(*map(to, params)), row_offset=a)])
    for x, y in zip(*out):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_pipelined_card_equals_cpu():
    """Every state of the pipelined app (pose and maps) bit-equal on the
    card and the CPU over five frames; the stages ran on two streams of
    their own."""
    needs_card()
    seq = frames()
    cpu, _ = pipelined_states("cpu", seq)
    card, vo = pipelined_states("cuda", seq)
    assert_states_equal(cpu, card)
    streams = {vo._tracker.stream, vo._mapper.stream}
    assert len(streams) == 2
    assert torch.cuda.default_stream() not in streams


@pytest.mark.cuda
@pytest.mark.parametrize("slow", ["mapper", "tracker"])
def test_pipelined_waits_for_the_other_stage(monkeypatch, slow):
    """With one stage's stream held back by a spin before each of its
    programs, the other stage still reads only finished tensors: the
    states stay bit-equal to the CPU's.  A missing event wait shows here
    as a read of a map or pose not yet written."""
    needs_card()
    seq = frames()
    cpu, _ = pipelined_states("cpu", seq)
    name = "map_stage" if slow == "mapper" else "track"
    real = getattr(pipelined, name)

    def held_back(*args, **kwargs):
        torch.cuda._sleep(50_000_000)
        return real(*args, **kwargs)

    monkeypatch.setattr(pipelined, name, held_back)
    card, _ = pipelined_states("cuda", seq)
    assert_states_equal(cpu, card)
