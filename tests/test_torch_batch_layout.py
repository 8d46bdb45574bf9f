"""PyTorch port: the batch kernel's launch geometry (`fused_aligner.batch_layout`).

The tiled batch kernel of ``csrc/fused_aligner.cu`` runs only on the card;
its geometry is Python that `fused_system_batch` itself launches with, so
the CPU reaches it here:

- every (current pixel, candidate) pair is summed by exactly one block and
  one thread, for ragged image sizes and K = 1-40 (exact counts);
- the groups fill the card at the loop closer's batch sizes, and five
  blocks of the largest group fit one SM's shared memory;
- K = 0, K beyond the reduction's grid, and an image or K tables beyond the
  kernel's int32 indexing raise ValueError, in `batch_layout` and in the
  wrapper on any device;
- at a ragged size (96x130, not a multiple of the tile) the wrapper's sums
  for K = 3 candidates equal JAX's `_correspondences_gather` +
  `_linearize_planar` per candidate: inliers equal, H, b and chi2 within
  rtol 1e-4 of their norms (the tolerance of tests/test_torch_aligner.py);
- the scan of `test_entry_points_default_to_cuda` reaches the module.
"""
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_frontend_tpu_torch
from g2o_frontend_tpu.pwn import aligner as ja
from g2o_frontend_tpu.pwn.converter import ConverterConfig, depth_to_cloud
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.ops import fused_aligner as tfa
from g2o_frontend_tpu_torch.slam import pwn_matcher as tm

torch.set_num_threads(1)

CLOSER_BATCHES = (1, 2, 4, 11, 12, 21)  # the K of the 1 m-radius closer's batches over the TUM keyframe map


@pytest.mark.parametrize("H,W", [(96, 130), (480, 640), (7, 9)])
def test_layout_covers_every_pair_once(H, W):
    n = H * W
    for K in range(1, 41):
        layout = tfa.batch_layout(H, W, K)
        counts = np.zeros((K, n), np.int32)
        for b in range(layout.blocks):
            cands, pix = layout.candidates(b), layout.pixels(b)
            assert 1 <= len(cands) <= layout.group <= tfa.BATCH_MAX_GROUP
            assert len(np.unique(pix)) == len(pix)
            counts[cands.start:cands.stop, pix] += 1
        assert (counts == 1).all(), (H, W, K)
        assert layout.scratch_shape == (K, -(-n // tfa.BATCH_TILE), tfa.N_SUMS)


def test_layout_fills_the_card():
    for K in CLOSER_BATCHES + (8,):
        layout = tfa.batch_layout(480, 640, K)
        assert layout.n_tiles == 1200
        assert layout.blocks >= min(tfa.FILL_BLOCKS, K * layout.n_tiles), K
        assert layout.group * (layout.n_groups - 1) < K <= layout.group * layout.n_groups
    # few candidates a block where the tiles alone do not fill the card
    assert tfa.batch_layout(96, 128, 21).group == 2
    # five blocks of the largest group fit one H100 SM's 228 KB of shared
    # memory, with the 1 KB that each block reserves
    largest = tfa.BatchLayout(480, 640, 8, tfa.BATCH_TILE, 1200, tfa.BATCH_MAX_GROUP, 1)
    assert 5 * (largest.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("H,W,K", [(96, 128, 0), (1, 8, tfa.MAX_K + 1), (2**13, 2**14, 1), (480, 640, 1000)],
                         ids=["no_candidates", "beyond_the_grid", "image_beyond_int32", "tables_beyond_int32"])
def test_layout_and_wrapper_reject(H, W, K):
    with pytest.raises(ValueError):
        tfa.batch_layout(H, W, K)
    # the wrapper rejects before it reads any other input, on the CPU too;
    # expanded tensors stand for the large ones
    proj = default_projector(H=H, W=W)
    tables = torch.zeros(1, 1, tfa.C_REF).expand(K, H * W, tfa.C_REF)
    cur_packed = torch.zeros(tfa.C_CUR, 1, 1).expand(tfa.C_CUR, H, W)
    params = torch.zeros(1, tfa.N_PARAMS).expand(K, tfa.N_PARAMS)
    with pytest.raises(ValueError):
        tfa.fused_system_batch(cur_packed, tables, params, convert.config_from(proj),
                               convert.config_from(ja.AlignerConfig()))


def test_layout_limits_are_reachable():
    assert tfa.batch_layout(1, 8, tfa.MAX_K).K == tfa.MAX_K
    assert tfa.batch_layout(480, 640, 21).n_groups == 3


def test_ragged_batch_matches_jax():
    proj = default_projector(H=96, W=130)
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    rng = np.random.default_rng(11)
    poses = [np.asarray(jlie.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.02, 3)]),
                                                 jnp.float32))) for _ in range(4)]
    clouds = [depth_to_cloud(render_planes_depth(T, proj), proj, ccfg) for T in poses]
    cur, refs = clouds[0], clouds[1:]
    invTs = np.stack([np.linalg.inv(np.linalg.inv(poses[0]) @ T) for T in poses[1:]]).astype(np.float32)
    cfg = ja.AlignerConfig()

    def port(c):
        return convert.cloud_from_numpy({k: np.asarray(v) for k, v in c._asdict().items()}, device="cpu")

    tproj, tcfg = convert.config_from(proj), convert.config_from(cfg)
    tables = tfa.pack_ref(tm.stack_clouds([port(c) for c in refs]))
    sums = tfa.fused_system_batch(tfa.pack_cur(port(cur)), tables, tfa.params_from_invT(torch.from_numpy(invTs)),
                                  tproj, tcfg)
    assert tuple(sums.shape) == (3, tfa.N_SUMS)
    for k, ref in enumerate(refs):
        m, rp, rn = ja._correspondences_gather(ref, cur, jnp.asarray(invTs[k]), proj, cfg)
        Hj, bj, cj, ij = (np.asarray(x, np.float64) for x in ja._linearize_planar(m, rp, rn, cur,
                                                                                  jnp.asarray(invTs[k]), cfg))
        Ht, bt, ct, it = (x.double().numpy() for x in tfa.unpack_sums(sums[k]))
        assert int(it) == int(ij) > 1000
        assert np.linalg.norm(Ht - Hj) <= 1e-4 * np.linalg.norm(Hj)
        assert np.linalg.norm(bt - bj) <= 1e-4 * np.linalg.norm(bj)
        assert abs(ct - cj) <= 1e-4 * abs(cj)


def test_entry_point_scan_covers_the_layout():
    """`test_entry_points_default_to_cuda` walks the package with pkgutil;
    the layout's module is among the modules it reads, and the new public
    names take no device (they compute shapes only)."""
    pkg = g2o_frontend_tpu_torch
    walked = {info.name for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    assert tfa.__name__ in walked
    for fn in (tfa.batch_layout, tfa.BatchLayout):
        assert "device" not in inspect.signature(fn).parameters
