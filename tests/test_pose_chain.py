"""Pose-bookkeeping chain parity (ops/pose_chain.py + ops/ffmath.py).

The fast fused-backend path runs the per-scan scalar pose math (reference
icp.cpp:36-86 + threshold.cpp) as two f32 chains with float-float
translations. These tests pin each chain against the f64 reference
implementations (lie/icp/kiss_icp), the float-float primitives against
f64 arithmetic, and the fused pair carrier end to end.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lidar_imu_slam_tpu import config as cfgmod
from lidar_imu_slam_tpu.models import kiss_icp
from lidar_imu_slam_tpu.ops import deskew as deskew_ops
from lidar_imu_slam_tpu.ops import icp as icp_ops
from lidar_imu_slam_tpu.ops import lie
from lidar_imu_slam_tpu.ops import ffmath, pose_chain


def _rand_pose(rng, scale_t=5.0, scale_r=0.3):
    xi = np.concatenate(
        [rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r]
    )
    return np.asarray(lie.se3_exp(jnp.asarray(xi)))


def _split(x):
    x = jnp.asarray(x, jnp.float64)
    hi = x.astype(jnp.float32)
    return hi, (x - hi.astype(jnp.float64)).astype(jnp.float32)


class TestFfMath:
    def test_two_sum_two_prod_exact(self):
        rng = np.random.default_rng(0)
        a = jnp.asarray(rng.uniform(-1e4, 1e4, 64), jnp.float32)
        b = jnp.asarray(rng.uniform(-1e-4, 1e-4, 64), jnp.float32)
        s, e = ffmath.two_sum(a, b)
        ref = a.astype(jnp.float64) + b.astype(jnp.float64)
        np.testing.assert_array_equal(
            np.asarray(s, np.float64) + np.asarray(e, np.float64), ref
        )
        p, pe = ffmath.two_prod(a, b)
        refp = a.astype(jnp.float64) * b.astype(jnp.float64)
        np.testing.assert_allclose(
            np.asarray(p, np.float64) + np.asarray(pe, np.float64),
            refp, rtol=1e-13,
        )

    def test_ff_chain_precision(self):
        # km-scale translation composed 1000x: ff must hold ~2^-40 absolute
        rng = np.random.default_rng(1)
        t64 = jnp.float64(1234.5678901234)
        h, l = _split(t64)
        inc = rng.uniform(-1e-3, 1e-3, 1000)
        acc = t64
        for d in inc:
            h, l = ffmath.add_f(h, l, jnp.float32(d))
            acc = acc + jnp.float64(np.float32(d))
        got = np.float64(h) + np.float64(l)
        assert abs(got - float(acc)) < 1e-8

    def test_atan2_pos(self):
        for th in [1e-7, 1e-3, 0.2, 1.0, 2.0, 2.5]:
            got = float(ffmath.atan2_pos(
                jnp.float32(np.sin(th)), jnp.float32(np.cos(th))
            ))
            assert abs(got - th) < 3e-6, th


class TestPosePre:
    @pytest.mark.parametrize("num_poses", [0, 1, 2, 5])
    def test_matches_f64_reference(self, num_poses):
        rng = np.random.default_rng(10 + num_poses)
        pose_prev = _rand_pose(rng)
        pose = np.asarray(lie.compose(
            jnp.asarray(pose_prev), jnp.asarray(_rand_pose(rng, 0.3, 0.05))
        ))
        first = _rand_pose(rng)
        md = _rand_pose(rng, 0.05, 0.01)
        thr = icp_ops.ThresholdState(
            jnp.float64(1.234), jnp.int32(7), jnp.asarray(md)
        )
        st = kiss_icp.KissState(
            None, jnp.asarray(pose), jnp.asarray(pose_prev),
            jnp.asarray(first), jnp.int32(num_poses), thr,
        )
        moved_ref = kiss_icp.has_moved(st, 0.1)
        guess_ref = lie.compose(
            jnp.where(st.num_poses == 0, jnp.eye(4, dtype=jnp.float64), st.pose),
            kiss_icp.get_prediction_model(st),
        )
        thr_ref, sigma_ref = icp_ops.compute_threshold(
            thr, moved_ref, 2.0, 0.1, 30.0
        )
        twist_ref = np.asarray(lie.delta_pose(st.pose_prev, st.pose))

        vec = jnp.concatenate([
            st.pose.reshape(16), st.pose_prev.reshape(16),
            st.first_pose.reshape(16), thr.model_error_sq.reshape(1),
        ])
        hi, lo = _split(vec)
        row = np.asarray(pose_chain.pose_pre(
            hi, lo, thr.model_deviation.reshape(16).astype(jnp.float32),
            jnp.stack([st.num_poses, thr.num_samples]),
            min_motion_th=0.1, initial_threshold=2.0, max_range=30.0,
            deskew_on=True,
        ))
        guess_k = np.eye(4)
        guess_k[:3, :3] = row[0:9].reshape(3, 3)
        guess_k[:3, 3] = row[9:12].astype(np.float64) + row[12:15].astype(np.float64)
        np.testing.assert_allclose(guess_k, np.asarray(guess_ref), atol=2e-6)
        assert bool(row[16] > 0.5) == bool(moved_ref)
        # the f32 model_deviation input floors the small-angle precision of
        # the accumulated model error at ~1e-4 relative (1 - cos(theta)
        # cancellation); sigma is a soft correspondence threshold
        np.testing.assert_allclose(row[15], float(sigma_ref), rtol=3e-4)
        np.testing.assert_allclose(
            row[17].astype(np.float64) + row[32].astype(np.float64),
            float(thr_ref.model_error_sq), rtol=3e-4,
        )
        assert int(row[18]) == int(thr_ref.num_samples)
        if num_poses > 2:
            w = twist_ref[3:]
            wn = np.linalg.norm(w)
            np.testing.assert_allclose(row[19], wn, atol=1e-5)
            np.testing.assert_allclose(row[20:23], w / wn, atol=1e-5)
            np.testing.assert_allclose(row[23:26], twist_ref[:3], rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(row[19:32], 0.0)

    def test_deskew_scalars_match_fast_deskew(self):
        rng = np.random.default_rng(3)
        pose_prev = _rand_pose(rng)
        pose = np.asarray(lie.compose(
            jnp.asarray(pose_prev), jnp.asarray(_rand_pose(rng, 0.5, 0.1))
        ))
        st = kiss_icp.KissState(
            None, jnp.asarray(pose), jnp.asarray(pose_prev),
            jnp.asarray(pose_prev), jnp.int32(5), icp_ops.threshold_init(),
        )
        vec = jnp.concatenate([
            st.pose.reshape(16), st.pose_prev.reshape(16),
            st.first_pose.reshape(16), jnp.zeros((1,), jnp.float64),
        ])
        hi, lo = _split(vec)
        row = pose_chain.pose_pre(
            hi, lo, jnp.eye(4, dtype=jnp.float32).reshape(16),
            jnp.stack([st.num_poses, jnp.int32(0)]),
            min_motion_th=0.1, initial_threshold=2.0, max_range=30.0,
            deskew_on=True,
        )
        pts = jnp.asarray(rng.uniform(-10, 10, (256, 3)), jnp.float32)
        tau = jnp.asarray(rng.uniform(0, 1, 256), jnp.float32)
        got = deskew_ops.deskew_from_scalars(pts, tau, row[19:32])
        ref = deskew_ops.constant_velocity_deskew_fast(
            pts, tau, st.pose_prev, st.pose
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), atol=5e-5
        )


class TestFloat32Chains:
    def test_no_float64_under_x64(self):
        """jax_enable_x64 is on at import: the chains must stay f32."""
        f32 = jnp.float32
        pre = jax.make_jaxpr(lambda h, l, m, i: pose_chain.pose_pre(
            h, l, m, i, min_motion_th=0.1, initial_threshold=2.0,
            max_range=30.0, deskew_on=True,
        ))(jnp.zeros(49, f32), jnp.zeros(49, f32), jnp.zeros(16, f32),
           jnp.zeros(2, jnp.int32))
        post = jax.make_jaxpr(lambda a: pose_chain.pose_post(
            a, max_model_deviation=10.0))(jnp.zeros(30, f32))
        for jaxpr in (pre, post):
            dtypes = {str(v.aval.dtype) for e in jaxpr.eqns for v in e.outvars}
            assert "float64" not in dtypes, dtypes
        with pytest.raises(TypeError):
            pose_chain.pose_post(jnp.zeros(30, jnp.float64),
                                 max_model_deviation=10.0)


class TestPosePost:
    @pytest.mark.parametrize("diverge", [False, True])
    def test_matches_f64_reference(self, diverge):
        rng = np.random.default_rng(4 + diverge)
        guess = _rand_pose(rng)
        scale = 20.0 if diverge else 0.05
        corr = np.asarray(lie.se3_exp(jnp.asarray(
            np.concatenate([rng.normal(size=3) * scale,
                            rng.normal(size=3) * 0.02])
        )))
        pose_icp = corr @ guess

        model_dev = np.linalg.inv(guess) @ pose_icp
        diverged_ref = np.linalg.norm(model_dev[:3, 3]) > 10.0
        assert diverged_ref == diverge
        sel = guess if diverged_ref else pose_icp
        new_pose_ref = np.asarray(lie.orthonormalize(jnp.asarray(sel)))
        delta_ref = new_pose_ref @ np.linalg.inv(guess)
        md_ref = np.eye(4) if diverged_ref else model_dev

        ch, cl = _split(corr[:3, 3])
        gh, gl = _split(guess[:3, 3])
        a = jnp.concatenate([
            jnp.asarray(corr[:3, :3].reshape(9), jnp.float32), ch, cl,
            jnp.asarray(guess[:3, :3].reshape(9), jnp.float32), gh, gl,
        ])
        prow = np.asarray(pose_chain.pose_post(a, max_model_deviation=10.0))
        Rn = prow[0:9].reshape(3, 3)
        tn = prow[9:12].astype(np.float64) + prow[12:15].astype(np.float64)
        assert bool(prow[15] > 0.5) == diverged_ref
        np.testing.assert_allclose(Rn, new_pose_ref[:3, :3], atol=3e-7)
        np.testing.assert_allclose(tn, new_pose_ref[:3, 3], atol=2e-6)
        # Newton orthonormalization floors at f32 eps
        assert np.abs(Rn @ Rn.T - np.eye(3)).max() < 5e-7
        np.testing.assert_allclose(
            prow[16:25].reshape(3, 3), delta_ref[:3, :3], atol=3e-7
        )
        np.testing.assert_allclose(prow[25:28], delta_ref[:3, 3], atol=2e-6)
        np.testing.assert_allclose(
            prow[28:44].reshape(4, 4), md_ref, atol=2e-6
        )


class TestFastPathIntegration:
    def test_fast_path_matches_classic_pallas_core(self):
        """The fast register_frame must track the classic fused register
        trunk scan by scan (the same GN kernel drives both; only the pose
        bookkeeping moved into kernels)."""
        from lidar_imu_slam_tpu.host import synthetic
        from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan

        cfg = cfgmod.PipelineConfig(
            lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=4096),
            map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 13),
            icp=cfgmod.IcpConfig(max_map_points=2048, max_source_points=512,
                                 gn_backend="fused", deskew=True),
        )
        world = synthetic.make_world(seed=0, n_points=40_000, extent=(30.0, 10.0, 5.0))
        gt = synthetic.make_trajectory(n_poses=6, speed=1.0, yaw_rate=0.05, dt=0.1)
        state = kiss_icp.init_state(cfg)
        for i in range(6):
            pts = synthetic.render_scan(world, gt[i], 3000, 0.5, 30.0, noise=0.01, seed=i)
            scan = preprocess_scan(
                pack_raw_scan(pts, stamp=i * 0.1, max_points=4096), cfg.lidar
            )
            if cfg.icp.deskew:
                dsk = jax.lax.cond(
                    state.num_poses > 2,
                    lambda: deskew_ops.constant_velocity_deskew_fast(
                        scan.xyz, scan.tau, state.pose_prev, state.pose
                    ),
                    lambda: scan.xyz,
                )
            moved = kiss_icp.has_moved(state, cfg.icp.min_motion_th)
            last = jnp.where(
                state.num_poses == 0, jnp.eye(4, dtype=jnp.float64), state.pose
            )
            guess = lie.compose(last, kiss_icp.get_prediction_model(state))
            core = kiss_icp.register_core(
                state.map, state.threshold, moved, dsk, scan.mask, guess,
                cfg, tau=scan.tau,
            )
            s2, out2 = kiss_icp._register_frame_fast(state, scan, cfg)
            np.testing.assert_allclose(
                np.asarray(out2.pose), np.asarray(core.pose), atol=1e-4
            )
            assert int(out2.icp_iterations) == int(core.icp_iterations)
            state = kiss_icp.KissState(
                map=core.new_map, pose=core.pose,
                pose_prev=jnp.where(state.num_poses == 0, core.pose, state.pose),
                first_pose=jnp.where(state.num_poses == 0, core.pose, state.first_pose),
                num_poses=state.num_poses + 1, threshold=core.threshold,
            )


class TestCompactInsert:
    def test_equivalence_and_cap(self):
        import dataclasses

        from lidar_imu_slam_tpu.ops import voxel_map

        rng = np.random.default_rng(0)
        base = cfgmod.MapConfig(
            voxel_size=1.0, max_range=30.0, capacity=1 << 12,
            max_points_per_voxel=4,
        )
        pts1 = rng.uniform(-20, 20, size=(3000, 3)).astype(np.float32)
        pts2 = pts1 + rng.normal(0, 2.0, size=pts1.shape).astype(np.float32)
        mask = jnp.asarray(rng.random(3000) > 0.1)

        def run(cfg):
            m = voxel_map.create(cfg)
            for pts in (pts1, pts2):
                g = voxel_map.fused_downsample(
                    jnp.asarray(pts), mask, cfg.voxel_size, 2048
                )
                keys = voxel_map.pack_key(
                    voxel_map.voxel_of(g.points, cfg.voxel_size)
                )
                m = voxel_map.insert_grouped(m, g, cfg, keys=keys)
            return m

        def canon(m, cfg):
            pts, msk = voxel_map.export_points(m, cfg)
            p = np.asarray(pts)[np.asarray(msk)]
            return np.sort(
                p.view([("x", "f4"), ("y", "f4"), ("z", "f4")]),
                order=["x", "y", "z"], axis=0,
            )

        m_ref = run(base)
        m_cmp = run(dataclasses.replace(base, max_insert_voxels=2047))
        assert np.array_equal(canon(m_ref, base), canon(m_cmp, base))
        assert int(voxel_map.num_voxels(m_ref)) == int(voxel_map.num_voxels(m_cmp))
        assert int(m_cmp.drops) == 0

        m_cap = run(dataclasses.replace(base, max_insert_voxels=64))
        assert int(voxel_map.num_voxels(m_cap)) <= 2 * 64
        assert int(m_cap.drops) > 0  # capped groups are counted, not silent
