"""Perception and the node's tick on the card against the same code on the
CPU.

Marked ``cuda``: it skips without an NVIDIA GPU.  It imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_perception_cuda.py

`pipeline.step` at B=64 pipelines over 10 frames of the synthetic walk:
found flags, DBSCAN labels and track ids equal, centres and track
positions within 1e-5 m on every pipeline (every operation of the pipeline
is elementwise or an exact selection, and the cluster means are summed in
a fixed order, so the two devices agree to the bit unless a correctly
rounded sqrt differs); `replay_session` on both devices: every frame's
obstacles within 1e-5; one `io.Model` tick at the node's defaults with 4
obstacle slots: commands within 1e-3.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kissmpc_tpu_torch.io.frames import FrameReplayer, replay_session
from kissmpc_tpu_torch.io.model import Model
from kissmpc_tpu_torch.perception.tracker import TrackerConfig

B, FRAMES = 64, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def walk(tmp_path):
    path = str(tmp_path / "walk.npz")
    frames, _ = chip_smoke.walk_frames(path, 2 * FRAMES)
    return path, frames


@pytest.mark.cuda
def test_pipeline_step_card_matches_cpu(cuda, walk):
    _, frames = walk
    card = chip_smoke.run_pipelines(frames, B, FRAMES, "cuda")
    cpu = chip_smoke.run_pipelines(frames, B, FRAMES, "cpu")
    agree, differ, worst = chip_smoke.compare_pipelines(card, cpu)
    assert agree == B, (differ, worst)
    assert int(card[-1][3].ge(0).sum()) == B  # every pipeline holds the walker


@pytest.mark.cuda
def test_replay_session_card_matches_cpu(cuda, walk):
    path, _ = walk
    (s_g, o_g), (s_c, o_c) = (replay_session(FrameReplayer(path), TrackerConfig(), capacity=4,
                                             device=dev) for dev in ("cuda", "cpu"))
    assert len(o_g) == len(o_c) == 2 * FRAMES
    for g, c in zip(o_g, o_c):
        for a, b in zip(g, c):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(s_g.tracks.track_id.cpu().numpy(), s_c.tracks.track_id.numpy())


@pytest.mark.cuda
def test_model_tick_card_matches_cpu(cuda, walk):
    path, _ = walk
    cmds = []
    for dev in ("cuda", "cpu"):
        model = Model(max_obstacles=4, waypoints=[chip_smoke.NODE_PLAN[0]], device=dev)
        _, per_frame = replay_session(FrameReplayer(path), TrackerConfig(), capacity=4,
                                      device=dev)
        model.set_obstacles(per_frame[-1]._replace(position=per_frame[-1].position + 1.0))
        model.step()
        cmds.append((model.linear_velocity, model.angular_velocity))
    np.testing.assert_allclose(cmds[0], cmds[1], atol=1e-3, rtol=0)
