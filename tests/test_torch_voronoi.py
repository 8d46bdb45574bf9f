"""PyTorch port: the jump-flood distance transform, Voronoi edges and
skeleton, the manifold grid and diagram, the Voronoi graph and the manifold
Voronoi extractor, against the JAX package.

Both packages run on the CPU, on grids of 32x32 to 100x100.

Tolerances (all exact: the transform's distances are integer sums of
squares, the grid is integer arithmetic on the same float32 points):
- `distance_transform`: distance and nearest seed equal, also with a
  cut number of rounds and with no seed at all;
- `voronoi_edges` and `skeletonize`: equal masks;
- `manifold_grid`: height and obstacle equal, including points at -0.5
  cells, which truncate into cell 0 as JAX's ``astype`` does;
- `manifold_diagram`: distance, edges and skeleton equal; the Voronoi graph
  of the port's copy of ``ops/voronoi_graph.py`` on the port's edges equal
  to JAX's on JAX's;
- `ManifoldVoronoiExtractor` over keyframe clouds of the synthetic room,
  the deque holding the last 3 of 5: height and obstacle equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.ops import distance_transform as jdt
from g2o_frontend_tpu.ops import voronoi_graph as jvg
from g2o_frontend_tpu.pwn.converter import ConverterConfig as JConverterConfig
from g2o_frontend_tpu.pwn.converter import depth_to_cloud as jdepth_to_cloud
from g2o_frontend_tpu.slam import manifold_voronoi as jmv
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.ops import distance_transform as tdt
from g2o_frontend_tpu_torch.ops import voronoi_graph as tvg
from g2o_frontend_tpu_torch.slam import manifold_voronoi as tmv

torch.set_num_threads(1)


def _obstacles(shape, density, seed):
    rng = np.random.default_rng(seed)
    occ = rng.random(shape) < density
    occ[shape[0] // 3, 2:-2] = True  # a wall
    return occ


@pytest.mark.parametrize("shape,density,rounds", [((32, 32), 0.02, 0), ((64, 48), 0.005, 0), ((100, 100), 0.01, 0),
                                                  ((100, 100), 0.01, 3)])
def test_distance_transform_matches_jax(shape, density, rounds):
    occ = _obstacles(shape, density, seed=shape[0] + rounds)
    dj, nj = jdt.distance_transform(jnp.asarray(occ), max_rounds=rounds)
    dt, nt = tdt.distance_transform(torch.from_numpy(occ), max_rounds=rounds)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for sep in (1.0, 2.0, 4.0):
        np.testing.assert_array_equal(tdt.voronoi_edges(nt, sep).numpy(), np.asarray(jdt.voronoi_edges(nj, sep)))
    for thr in (0.5, 1.0, 3.0):
        np.testing.assert_array_equal(tdt.skeletonize(dt, thr).numpy(), np.asarray(jdt.skeletonize(dj, thr)))
    assert int(tdt.voronoi_edges(nt).sum()) > 0


def test_distance_transform_without_seeds():
    occ = np.zeros((32, 32), bool)
    dj, nj = jdt.distance_transform(jnp.asarray(occ))
    dt, nt = tdt.distance_transform(torch.from_numpy(occ))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert bool(torch.isinf(dt).all()) and not bool(tdt.voronoi_edges(nt).any())


def _corridor(n, seed):
    """Floor z = 0 (normal +z) in |y| < 2, walls at y = +-2 with horizontal
    normals, x in [-8, 8], as channel-planar (1, 3, 1, N) arrays; plus
    points at -0.5 and -1.5 cells from the grid's first row and column."""
    rng = np.random.default_rng(seed)
    xf, yf = rng.uniform(-8, 8, n), rng.uniform(-2, 2, n)
    xw, zw = rng.uniform(-8, 8, n), rng.uniform(0, 1.5, n)
    pts = np.concatenate([np.stack([xf, yf, np.zeros(n)], -1), np.stack([xw, np.full(n, 2.0), zw], -1),
                          np.stack([xw, np.full(n, -2.0), zw], -1)])
    nrm = np.concatenate([np.tile([0.0, 0.0, 1.0], (n, 1)), np.tile([0.0, 1.0, 0.0], (2 * n, 1))])
    edge = -10.0 - np.array([[0.1, 0.1, 0.5], [0.3, 0.3, 0.2], [0.1, 0.5, 0.0]])  # -0.5 / -1.5 cells at 0.2 m
    pts = np.concatenate([pts, edge])
    nrm = np.concatenate([nrm, np.tile([0.0, 0.0, 1.0], (3, 1))])
    valid = rng.random(len(pts)) > 0.05
    valid[-3:] = True
    return (pts.T[None, :, None, :].astype(np.float32), nrm.T[None, :, None, :].astype(np.float32),
            valid[None, None, :])


@pytest.mark.parametrize("size,resolution", [(100, 0.2), (32, 0.5), (64, 0.25)])
def test_manifold_grid_and_diagram_match_jax(size, resolution):
    pts, nrm, val = _corridor(3000, seed=size)
    kw = dict(x_size=size, y_size=size, resolution=resolution, normal_threshold=0.64)
    hj, oj = jmv.manifold_grid(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(val), **kw)
    ht, ot = tmv.manifold_grid(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(val), **kw)
    assert ht.dtype == torch.int32
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert int(ot.sum()) > 0 and int((ht < tmv._FREE_INIT).sum()) > int(ot.sum())
    for sq in (2, 4):
        outs_j = jmv.manifold_diagram(oj, squared_resolution=sq)
        outs_t = tmv.manifold_diagram(ot, squared_resolution=sq)
        for a, b in zip(outs_t, outs_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gt, gj = tvg.extract_graph(outs_t[1].numpy(), outs_t[0].numpy()), jvg.extract_graph(np.asarray(outs_j[1]),
                                                                                         np.asarray(outs_j[0]))
    for name in ("vertices", "vertex_dist", "components", "n_components"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name), err_msg=name)
    assert len(gt.edges) == len(gj.edges) > 0
    for (i, j, length, path), (i2, j2, length2, path2) in zip(gt.edges, gj.edges):
        assert (i, j, length) == (i2, j2, length2)
        np.testing.assert_array_equal(path, path2)


def test_manifold_grid_truncates_toward_zero():
    """A point at -0.5 cells lands in cell 0 (truncation), as in JAX; floor
    would drop it from the grid."""
    size, res = 8, 1.0
    pts = np.array([[-4.5, -4.5, 0.0], [-4.5 + 1.0, -4.5, 1.0], [-5.5, 0.0, 0.0]], np.float32)  # cells -0.5, 0.5, -1.5
    pts = pts.T[None, :, None, :]
    nrm = np.tile(np.array([0.0, 0.0, 1.0], np.float32)[:, None, None], (1, 1, 3))[None]
    val = np.ones((1, 1, 3), bool)
    kw = dict(x_size=size, y_size=size, resolution=res)
    ht, _ = tmv.manifold_grid(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(val), **kw)
    hj, _ = jmv.manifold_grid(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(val), **kw)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert int(ht[0, 0]) == 9000  # the z = 1 point wins cell 0 with the z = 0 one (10000 - 1000 z)
    assert int((ht < tmv._FREE_INIT).sum()) == 1


def test_manifold_voronoi_extractor_matches_jax():
    proj = default_projector(H=48, W=64)
    ccfg = JConverterConfig(min_image_radius=2, max_image_radius=5, min_points=8)
    cfg = dict(resolution=0.1, x_size=64, y_size=64, normal_threshold=0.64, deque_size=3)
    ej, et = jmv.ManifoldVoronoiExtractor(jmv.ManifoldVoronoiConfig(**cfg)), tmv.ManifoldVoronoiExtractor(
        tmv.ManifoldVoronoiConfig(**cfg))
    for k in range(5):
        T = np.asarray(jlie.se3_exp(jnp.asarray([0.1 * k, 0.0, 0.05 * k, 0.0, 0.1 * k, 0.0], jnp.float32)))
        jc = jdepth_to_cloud(jnp.asarray(render_planes_depth(T, proj)), proj, ccfg)
        ej.add_keyframe(k, jc, T.astype(np.float32))
        et.add_keyframe(k, convert.cloud_from_numpy({n: np.asarray(v) for n, v in jc._asdict().items()}, device="cpu"),
                        T.astype(np.float32))
    assert [e[0] for e in et._entries] == [e[0] for e in ej._entries] == [2, 3, 4]
    for key in (None, 3):
        dj, dt = ej.extract(key), et.extract(key)
        assert (dt.node_id, dt.resolution) == (dj.node_id, dj.resolution)
        np.testing.assert_array_equal(dt.height.numpy(), np.asarray(dj.height))
        np.testing.assert_array_equal(dt.obstacle.numpy(), np.asarray(dj.obstacle))
        assert int(dt.obstacle.sum()) > 0
    with pytest.raises(ValueError):
        tmv.ManifoldVoronoiExtractor().extract()
