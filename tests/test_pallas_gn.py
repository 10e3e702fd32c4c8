"""Fused f32 GN-ICP loop vs the f64 XLA path (ops/icp_gn.py).

The fused loop is all-f32 on centered coordinates with a Jacobi-
preconditioned Cholesky; these tests pin its pose agreement with
`icp_registration` (the reference-faithful f64 path, reference
registration.cpp:94-130), its nearest-neighbour reduction against a
sequential scan, its batching under `jax.vmap`, and that it stays f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lidar_imu_slam_tpu.config import MapConfig
from lidar_imu_slam_tpu.ops import icp as icp_ops
from lidar_imu_slam_tpu.ops import voxel_map

CFG = MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 13,
                neighborhood=27)


def _make_map(seed=0, n=3000, offset=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    world = (rng.uniform(-18, 18, size=(n, 3)) + np.asarray(offset)).astype(
        np.float32
    )
    m = voxel_map.create(CFG)
    m = voxel_map.insert(m, jnp.asarray(world), jnp.ones(n, bool), CFG)
    return m, world


class TestFusedVsXla:
    def test_pose_agreement(self):
        m, world = _make_map()
        t_true = np.array([0.25, -0.15, 0.1])
        src = (world[:1024] - t_true).astype(np.float32)
        mask = jnp.ones(1024, bool)
        eye = jnp.eye(4, dtype=jnp.float64)

        r_x = icp_ops.icp_registration(
            m, jnp.asarray(src), mask, eye, 1.5, 0.5, CFG, 30, 1e-5
        )
        r_p = icp_ops.icp_registration_fused(
            m, jnp.asarray(src), mask, eye, 1.5, 0.5, CFG, 30, 1e-5
        )
        assert bool(r_p.converged)
        np.testing.assert_allclose(
            np.asarray(r_p.pose)[:3, 3], t_true, atol=0.02
        )
        # f32 kernel vs f64 XLA: sub-mm pose agreement
        assert np.abs(np.asarray(r_p.pose) - np.asarray(r_x.pose)).max() < 1e-3

    def test_far_from_origin_precision(self):
        # centering must keep f32 accurate with world coords ~300 m out
        m, world = _make_map(offset=(300.0, -250.0, 40.0))
        t_true = np.array([0.2, 0.1, -0.05])
        src = (world[:1024] - t_true).astype(np.float32)
        mask = jnp.ones(1024, bool)
        eye = jnp.eye(4, dtype=jnp.float64)
        r_p = icp_ops.icp_registration_fused(
            m, jnp.asarray(src), mask, eye, 1.5, 0.5, CFG, 30, 1e-5
        )
        np.testing.assert_allclose(
            np.asarray(r_p.pose)[:3, 3], t_true, atol=0.03
        )

    def test_nonidentity_guess_and_rotation(self):
        from lidar_imu_slam_tpu.ops import lie

        m, world = _make_map()
        xi = jnp.asarray([0.3, -0.2, 0.05, 0.01, -0.02, 0.04], jnp.float64)
        T_true = lie.se3_exp(xi)
        Tinv = np.asarray(lie.transform_inverse(T_true))
        src = (world[:1024] @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
        mask = jnp.ones(1024, bool)
        guess = lie.se3_exp(xi * 0.9)  # near-correct initial guess
        r_p = icp_ops.icp_registration_fused(
            m, jnp.asarray(src), mask, guess, 1.5, 0.5, CFG, 60, 1e-5,
            n_inner=8,
        )
        np.testing.assert_allclose(
            np.asarray(r_p.pose), np.asarray(T_true), atol=0.02
        )

    def test_starved_correspondences_freeze(self):
        m, _ = _make_map()
        src = np.full((256, 3), 500.0, np.float32)  # far outside the map
        r_p = icp_ops.icp_registration_fused(
            m, jnp.asarray(src), jnp.ones(256, bool),
            jnp.eye(4, dtype=jnp.float64), 1.5, 0.5, CFG, 30, 1e-5,
        )
        # starved -> identity correction, flagged converged-by-starvation
        np.testing.assert_allclose(
            np.asarray(r_p.pose), np.eye(4), atol=1e-9
        )
        assert int(r_p.num_correspondences) == 0

    def test_empty_map_returns_guess(self):
        m = voxel_map.create(CFG)
        guess = jnp.eye(4, dtype=jnp.float64).at[0, 3].set(2.5)
        src = np.zeros((128, 3), np.float32)
        r = icp_ops.icp_registration_fused(
            m, jnp.asarray(src), jnp.ones(128, bool), guess, 1.5, 0.5, CFG,
            30, 1e-5,
        )
        np.testing.assert_allclose(np.asarray(r.pose), np.asarray(guess))
        assert not bool(r.converged)


def _sequential_nn(w, c):
    """Reference: the strict-< running-min scan over candidate slots."""
    nc, n = c.shape[1], c.shape[2]
    best = np.full(n, np.inf, np.float32)
    pt = np.zeros((3, n), np.float32)
    for j in range(nc):
        d2 = ((c[0, j] - w[0]) ** 2 + (c[1, j] - w[1]) ** 2
              + (c[2, j] - w[2]) ** 2).astype(np.float32)
        hit = d2 < best
        best = np.where(hit, d2, best)
        pt[:, hit] = c[:, j, hit]
    return best, pt


class TestNearestCandidate:
    def test_reduction_matches_sequential_scan(self):
        from lidar_imu_slam_tpu.ops import icp_gn

        rng = np.random.default_rng(7)
        n, nc = 257, 80
        # coordinates on a coarse grid so exact distance ties are common
        w = rng.integers(-4, 5, size=(3, n)).astype(np.float32)
        c = rng.integers(-4, 5, size=(3, nc, n)).astype(np.float32)
        c[:, 30:, :64] = np.inf  # partly empty rows
        c[:, :, 64:96] = np.inf  # rows with no candidate at all
        c[0, 5, 100] = np.nan  # a NaN slot never wins
        ties = 0
        for j in range(n):
            d = ((c[:, :, j] - w[:, j:j + 1]) ** 2).sum(0)
            ties += int(np.sum(d == np.nanmin(d)) > 1)
        assert ties > 50
        best, bx, by, bz = icp_gn.nearest_candidate(
            *map(jnp.asarray, (w[0], w[1], w[2], c[0], c[1], c[2])))
        ref_best, ref_pt = _sequential_nn(w, c)
        np.testing.assert_array_equal(np.asarray(best), ref_best)
        np.testing.assert_array_equal(
            np.stack([np.asarray(bx), np.asarray(by), np.asarray(bz)]),
            ref_pt)
        assert np.isinf(np.asarray(best)[64:96]).all()
        np.testing.assert_array_equal(np.asarray(bx)[64:96], 0.0)


class TestBenchWidth:
    @pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0),
                                        (300.0, -250.0, 40.0)])
    def test_fused_vs_f64_at_4096x80(self, offset):
        """4,096 source points against 8 voxels x 10 points = 80
        candidates per query (the kitti_64beam width)."""
        cfg = MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 15,
                        neighborhood=8)
        assert 8 * cfg.packed_width == 80
        rng = np.random.default_rng(0)
        world = (rng.uniform(-18, 18, size=(30000, 3))
                 + np.asarray(offset)).astype(np.float32)
        m = voxel_map.insert(voxel_map.create(cfg), jnp.asarray(world),
                             jnp.ones(len(world), bool), cfg)
        t_true = np.array([0.25, -0.15, 0.1])
        src = jnp.asarray((world[:4096] - t_true).astype(np.float32))
        mask = jnp.ones(4096, bool)
        eye = jnp.eye(4, dtype=jnp.float64)
        r_x = icp_ops.icp_registration(m, src, mask, eye, 1.5, 0.5, cfg,
                                       30, 1e-5)
        r_p = icp_ops.icp_registration_fused(m, src, mask, eye, 1.5, 0.5,
                                             cfg, 30, 1e-5)
        assert bool(r_p.converged)
        np.testing.assert_allclose(np.asarray(r_p.pose)[:3, 3], t_true,
                                   atol=0.02)
        assert np.abs(np.asarray(r_p.pose) - np.asarray(r_x.pose)).max() < 1e-3


def _gn_operands(seed, n=384, nc=24):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-15, 15, (3, n)).astype(np.float32)
    cand = (q[:, None, :] + 0.05
            + rng.normal(0, 0.2, (3, nc, n))).astype(np.float32)
    cand[:, nc // 2:, : n // 4] = np.inf
    qm = (rng.random(n) > 0.1).astype(np.float32)
    scal = np.array([0.3, 1.0, 1e-5, 20, 2.0, 0.25], np.float32)
    return q, qm, cand, scal


class TestPlainGn:
    def test_vmap_matches_per_stream(self):
        from lidar_imu_slam_tpu.ops import icp_gn

        ops = [_gn_operands(s) for s in range(3)]
        stacked = [jnp.asarray(np.stack(x)) for x in zip(*ops)]
        batched = jax.jit(jax.vmap(
            lambda q, qm, c, s: icp_gn.fused_gn(q, qm, c, s, 4)))(*stacked)
        for i, op in enumerate(ops):
            single = icp_gn.fused_gn(*map(jnp.asarray, op), 4)
            for b, s in zip(batched, single):
                np.testing.assert_allclose(
                    np.asarray(b[i], np.float64), np.asarray(s, np.float64),
                    rtol=1e-5, atol=1e-6)

    def test_stays_float32_under_x64(self):
        """jax_enable_x64 is on at import: no value of the fused loop may be
        promoted to f64."""
        from lidar_imu_slam_tpu.ops import icp_gn

        q, qm, cand, scal = map(jnp.asarray, _gn_operands(0))
        carry = jnp.zeros(18, jnp.float32)
        jaxpr = jax.make_jaxpr(
            lambda *a: icp_gn.fused_gn_carry(*a, 3))(q, qm, cand, scal, carry)
        dtypes = {str(v.aval.dtype) for eqn in jaxpr.eqns for v in eqn.outvars}
        assert "float64" not in dtypes, dtypes
        with pytest.raises(TypeError):
            icp_gn.fused_gn(q.astype(jnp.float64), qm, cand, scal, 1)


class TestBatched:
    def test_unrolled_vmap_matches_single(self):
        m, world = _make_map()
        offsets = np.array([[0.2, 0.0, 0.0], [-0.1, 0.15, 0.05],
                            [0.0, -0.2, 0.1], [0.05, 0.05, -0.1]])
        srcs = np.stack(
            [(world[:1024] - o).astype(np.float32) for o in offsets]
        )
        masks = jnp.ones((4, 1024), bool)
        eye = jnp.eye(4, dtype=jnp.float64)

        def one(src, mask):
            return icp_ops.icp_registration_fused_unrolled(
                m, src, mask, eye, 1.5, 0.5, CFG, 2, 6, 1e-5
            )

        batched = jax.vmap(one)(jnp.asarray(srcs), masks)
        for i, o in enumerate(offsets):
            single = one(jnp.asarray(srcs[i]), masks[i])
            np.testing.assert_allclose(
                np.asarray(batched.pose[i])[:3, 3], o, atol=0.02
            )
            # vmapped fused loop == unbatched fused loop
            np.testing.assert_allclose(
                np.asarray(batched.pose[i]), np.asarray(single.pose),
                atol=1e-6,
            )


class TestPipelineBackend:
    def test_register_frame_pallas_backend(self):
        """The fused backend tracks the f64 backend through register_frame."""
        import dataclasses

        from lidar_imu_slam_tpu import config as cfgmod
        from lidar_imu_slam_tpu.models import kiss_icp

        cfg = cfgmod.PipelineConfig(
            lidar=cfgmod.LidarConfig(max_points=4096, min_range=1.0,
                                     max_range=60.0),
            map=cfgmod.MapConfig(voxel_size=1.0, max_range=60.0,
                                 capacity=1 << 13),
            icp=cfgmod.IcpConfig(max_map_points=4096,
                                 max_source_points=1024),
        )
        cfg_p = cfg.replace(
            icp=dataclasses.replace(cfg.icp, gn_backend="fused")
        )
        rng = np.random.default_rng(3)
        from lidar_imu_slam_tpu.ops.preprocess import (
            pack_raw_scan, preprocess_scan,
        )

        pts = rng.uniform(-30, 30, size=(4096, 3)).astype(np.float32)
        pts = pts[np.linalg.norm(pts, axis=1) > 2.0]
        scan = preprocess_scan(
            pack_raw_scan(pts, stamp=0.0, max_points=4096), cfg.lidar
        )
        s_x = kiss_icp.init_state(cfg)
        s_p = kiss_icp.init_state(cfg_p)
        for _ in range(3):
            s_x, o_x = kiss_icp.register_frame_jit(s_x, scan, cfg)
            s_p, o_p = kiss_icp.register_frame_jit(s_p, scan, cfg_p)
        np.testing.assert_allclose(
            np.asarray(o_p.pose), np.asarray(o_x.pose), atol=1e-3
        )


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-v"]))
