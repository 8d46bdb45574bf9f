"""The seeded generators: the same bits for the same seed, the path's
period and speeds, the backend world's counts."""
import math

import numpy as np
import torch

from perfbench import harness, small
from perfbench.gen import depth, se2_world
from perfbench.reference import se2 as ref_se2

FULL = harness.load_json(harness.ROOT / "perfbench/configs/pwn_tum_fr1.json")


def test_path_is_periodic_at_fr1_desk_speeds():
    seq = FULL["sequence"]
    T = depth.camera_path(seq)
    assert T.shape == (600, 4, 4)
    speed, turn = depth._mean_speed(T, seq["rate_hz"])
    assert abs(speed - seq["speed_m_per_s"]) < 1e-3 and abs(math.degrees(turn) - seq["turn_deg_per_s"]) < 1e-2
    steps = (torch.roll(T, -1, 0)[:, :3, 3] - T[:, :3, 3]).norm(dim=-1)
    # the step from the last frame back to the first is like every other: no seam
    assert steps.min() * 0.9 <= steps[-1] <= steps.max() * 1.1


def test_same_seed_same_depth_bits_another_seed_other_noise():
    cfg = small.config("pwn_tum_fr1")
    a, _ = depth.render_counts(cfg["sequence"], cfg["camera"], 2**31 + 5, "cpu")
    b, _ = depth.render_counts(cfg["sequence"], cfg["camera"], 2**31 + 5, "cpu")
    c, _ = depth.render_counts(cfg["sequence"], cfg["camera"], 7, "cpu")
    assert a.shape == (60, 120, 160) and torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) <= 65535
    z = a[a > 0].float() / cfg["camera"]["depth_counts_per_m"]
    assert 0.3 < float(z.median()) < 6.0
    assert abs(float((a == 0).float().mean()) - cfg["sequence"]["dropout_share"]) < 0.005


def test_backend_world_counts_and_seeded_ids():
    cfg = harness.load_json(harness.ROOT / "perfbench/configs/se2_victoria_park.json")["world"]
    small_cfg = small.config("se2_victoria_park")["world"]
    a, b = se2_world.g2o_text(small_cfg, 3), se2_world.g2o_text(small_cfg, 3)
    c = se2_world.g2o_text(small_cfg, 2**31 + 3)
    assert a == b and a != c
    ga, gc = ref_se2.parse_g2o(a), ref_se2.parse_g2o(c)
    # another seed relabels the vertices; the graph, row for row, is the same
    assert all(np.array_equal(x, y) for x, y in zip(ga, gc))
    gt, lms, odom, closures, obs = se2_world.simulate(cfg)
    # victoriaPark-full.g2o's counts: 6,969 poses, 151 landmarks, 10,608 edges
    assert (len(gt), len(lms), len(odom), len(closures), len(obs)) == (6969, 151, 6968, 0, 3640)
    assert 3 * len(gt) + 2 * len(lms) == 21209
    assert np.bincount([l for _, l, _, _ in obs], minlength=len(lms)).min() >= 2
