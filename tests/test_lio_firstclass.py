"""LIO runner first-class parity with the lidar-only runner (VERDICT round
2, missing #3/#4/#5 + next #4): loop-closure backend observation, frame
splitting with per-segment IMU packets, LiDAR loop-back state reset, and the
IMU packet-overflow counter."""

import numpy as np

from lidar_imu_slam_tpu import config as cfgmod
from lidar_imu_slam_tpu.host import synthetic
from lidar_imu_slam_tpu.host.runner import LioRunner
from lidar_imu_slam_tpu.host.stream_sync import StreamSynchronizer


def _cfg(**kw):
    lidar = dict(max_range=25.0, min_range=0.5, max_points=4096)
    lidar.update(kw.pop("lidar", {}))
    imu = dict(max_init_count=30, max_samples_per_scan=32)
    imu.update(kw.pop("imu", {}))
    backend = kw.pop("backend", None)
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(**lidar),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=25.0, capacity=1 << 13),
        icp=cfgmod.IcpConfig(
            max_map_points=4096, max_source_points=1024, max_iterations=30
        ),
        imu=cfgmod.ImuConfig(**imu),
        backend=(
            cfgmod.BackendConfig(**backend) if backend else cfgmod.BackendConfig()
        ),
        **kw,
    )


def _drive(n, seed=5, world=None, gt=None):
    world = world if world is not None else synthetic.make_world(
        seed=seed, n_points=60_000, extent=(40.0, 12.0, 5.0)
    )
    gt = gt if gt is not None else synthetic.make_trajectory(
        n_poses=n, speed=1.5, yaw_rate=0.02, dt=0.1
    )

    def scans():
        # per-point times across a 90 ms sweep: exercises the time sort and
        # gives frame splitting real sub-windows to cut at
        per_pt = np.linspace(0.0, 0.09, 3000)
        for i, p in enumerate(gt):
            yield {
                "xyz": synthetic.render_scan(world, p, 3000, 0.5, 25.0, seed=i),
                "time": i * 0.1 + per_pt,
                "stamp": i * 0.1,
            }

    rows = []
    for k in range(n * 10):
        rows.append([k * 0.01 + 0.0013, 0, 0, 0, 0, 0, 9.81])
    return scans, np.asarray(rows), gt


class TestLioBackend:
    def test_lio_feeds_loop_closure_backend(self):
        """`run_lio --loop-closure` must actually observe keyframes (the
        round-2 LioRunner silently ignored the backend)."""
        n = 24
        cfg = _cfg(
            backend=dict(
                enabled=True,
                max_keyframes=32,
                max_edges=128,
                keyframe_dist=0.25,
                keyframe_rot=10.0,
                chunk=4,
                optimize_every=4,
                loop_radius=10.0,
                min_index_gap=4,
                max_candidates=2,
                verify_max_residual=0.75,
                verify_min_correspondences=50,
                lm_iterations=4,
            )
        )
        scans, imu, gt = _drive(n)
        r = LioRunner(cfg).run_lio(scans(), imu)
        assert r.backend is not None
        assert len(r.backend.kf_poses) >= 4, "backend never observed"
        assert r.backend.num_optimizations >= 1
        opt = r.optimized_poses()
        assert opt.shape == np.stack(r.poses).shape
        assert np.isfinite(opt).all()


class TestLioLoopBack:
    def test_loop_back_resets_state(self):
        """Replaying a bag (stamps wrap to 0) must reset the LIO state: the
        first post-wrap pose restarts near identity instead of continuing
        from the stale map/EKF (round-2 dropped the synchronizer's flag)."""
        n = 8
        scans_fn, imu, gt = _drive(n)
        msgs = list(scans_fn())
        replay = msgs + [dict(m) for m in msgs]  # stamp regression at n

        cfg = _cfg()
        r = LioRunner(cfg).run_lio(iter(replay), imu)
        assert len(r.poses) == 2 * n
        moved = np.linalg.norm(r.poses[n - 1][:3, 3])
        assert moved > 0.25  # sanity: it drove somewhere pre-wrap
        # post-wrap restart: first replayed scan registers against an empty
        # map from an identity pose
        restart = np.linalg.norm(r.poses[n][:3, 3])
        assert restart < 0.25 * moved, (
            f"state not reset on loop-back ({restart:.3f} m vs {moved:.3f})"
        )


class TestLioSegments:
    def test_frame_split_tracks(self):
        """frame_split_num=2 LIO: segments run as independent sub-steps with
        per-segment IMU packets; tracking must stay close to the unsplit
        run (reference frame.cpp:53-99 splitting feeds its whole pipeline)."""
        n = 10
        scans_fn, imu, gt = _drive(n)
        base = LioRunner(_cfg()).run_lio(scans_fn(), imu)
        split_cfg = _cfg(
            lidar=dict(frame_split_num=2), min_scan_count=2
        )
        split = LioRunner(split_cfg).run_lio(scans_fn(), imu)
        assert len(split.poses) == n
        d = np.stack(base.poses)[:, :3, 3] - np.stack(split.poses)[:, :3, 3]
        # the split run registers at twice the cadence on half-scans — a
        # DIFFERENT (valid) estimator, so cm-level parity with the unsplit
        # run is not expected (the reference's split path also changes
        # results); it must track the same trajectory, not diverge
        assert np.isfinite(np.stack(split.poses)).all()
        assert np.max(np.linalg.norm(d, axis=1)) < 1.0
        assert np.linalg.norm(d[-1]) < 0.5


class TestImuOverflow:
    def test_take_until_counts_overflow(self):
        warns = []
        s = StreamSynchronizer(
            cfgmod.ImuConfig(max_samples_per_scan=8), warn=warns.append
        )
        for k in range(20):
            s.push_imu(0.005 * k, np.zeros(3), [0, 0, 9.81])
        take = s.take_until(1.0, 8)
        assert len(take) == 8
        assert s.last_overflow == 12
        assert s.total_overflow == 12
        assert any("overflow" in w for w in warns)
        # the KEPT samples are the most recent ones
        assert take[0, 0] == 0.005 * 12

    def test_no_overflow_in_standard_config(self):
        """The standard drive (100 Hz IMU, 10 Hz scans, cap 32) must never
        drop samples — asserting the counter is zero guards the default."""
        n = 6
        scans_fn, imu, gt = _drive(n)
        r = LioRunner(_cfg()).run_lio(scans_fn(), imu)
        assert all(
            int(m.get("imu_overflow", 0)) == 0 for m in r.metrics.records
        )

    def test_overflow_surfaces_in_metrics(self):
        n = 6
        scans_fn, imu, gt = _drive(n)
        r = LioRunner(_cfg(imu=dict(max_samples_per_scan=4))).run_lio(
            scans_fn(), imu
        )
        assert any(int(m.get("imu_overflow", 0)) > 0 for m in r.metrics.records)


class TestInMotionInit:
    """Round-4/5 filter changes (commits d788269 + round 5; PARITY.md
    #26/#27): odometry-seeded EKF init for static initializations that
    complete IN MOTION, scan-end nominal-state extrapolation, and online
    gravity estimation through the d(vel)/d(grav) Fx coupling.

    Regressions guarded:
      * without the odometry seed, init completing at 8 m/s reset the
        nominal state to identity/zero velocity, the next scan's guess
        teleported, and registration measured 305 ICP iterations with
        10.7 m error (round 4);
      * without the Fx gravity coupling (reference omission, PARITY #27),
        the launch-ramp-contaminated gravity seed (~48 deg off vertical
        here) could never be corrected: velocity error grew ~0.5 m/s per
        scan and ICP saturated at the iteration cap, non-converged.

    The drive uses ROLLING-shutter rendered scans (per-point poses): the
    rigid-rendered scans carry sweep timestamps the IMU undistortion would
    'correct', warping the cloud by ~0.8 m at 8 m/s."""

    def _drive_fast(self, n=22, speed=8.0, backend="xla"):
        """Direct lio.step drive at speed: make_trajectory ramps up to
        `speed` over the first ~2 s, so the 50-sample IMU init window sees
        a sustained 10+ m/s^2 forward specific force and completes around
        scan 4-5, several metres from the origin and still accelerating —
        the hardest in-motion completion case. backend="fused" routes
        registration through the LIO fast trunk (kiss_icp._fast_trunk)."""
        import dataclasses

        import jax

        from lidar_imu_slam_tpu.models import lio
        from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan

        cfg = _cfg(
            lidar=dict(max_range=40.0, min_range=0.5, max_points=4096),
            imu=dict(max_init_count=50, max_samples_per_scan=16),
        )
        cfg = cfg.replace(
            map=dataclasses.replace(
                cfg.map, max_range=40.0, capacity=1 << 14,
                store_points=(backend == "xla"),
            ),
            icp=dataclasses.replace(
                cfg.icp, deskew=True, gn_backend=backend,
            ),
            ekf=dataclasses.replace(cfg.ekf, lidar_pose_trail=2),
        )
        world = synthetic.make_world(
            seed=11, n_points=120_000, extent=(120.0, 30.0, 6.0)
        )
        gt = synthetic.make_trajectory(
            n_poses=n, speed=speed, yaw_rate=0.01, dt=0.1
        )
        times, gyros, accs = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)

        state = lio.init_state(cfg)
        outs = []
        for i in range(len(gt)):
            pe = gt[min(i + 1, len(gt) - 1)]
            pts, rel = synthetic.render_scan_rolling(
                world, gt[i], pe, 0.1, 4096, 0.5, 40.0, noise=0.01, seed=i
            )
            raw = pack_raw_scan(
                pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=4096
            )
            lo, hi = np.searchsorted(times, (i * 0.1, (i + 1) * 0.1))
            hi = min(hi, lo + 10)
            pkt = lio.pack_imu_packet(
                times[lo:hi] + 1e-3, gyros[lo:hi], accs[lo:hi], 16
            )
            state, out = lio.step_jit(
                state, preprocess_scan(raw, cfg.lidar), pkt, cfg
            )
            outs.append(jax.tree.map(np.asarray, out))
        return cfg, gt, outs

    def test_in_motion_init_fast_path(self):
        """Same drive through the LIO fast trunk (fused backend): must
        converge post-init and track (the fast path is the bench/production
        configuration)."""
        cfg, gt, outs = self._drive_fast(backend="fused")
        used = np.asarray([o.used_imu for o in outs])
        assert used.any()
        first = int(np.argmax(used))
        # exclude the final scan: its render clamps pose_end == pose_start
        # (rigid cloud with sweeping timestamps — a physically inconsistent
        # boundary artifact of the drive, not an estimator property)
        for i in range(first, len(outs) - 1):
            assert bool(outs[i].icp_converged), (
                f"scan {i} not converged ({int(outs[i].icp_iterations)} it)"
            )
        gt_rel = np.linalg.inv(gt[0]) @ gt[len(outs) - 1]
        err = np.linalg.norm(np.asarray(outs[-1].pose)[:3, 3] - gt_rel[:3, 3])
        assert err < 0.6, f"final tracking error {err:.3f} m"

    def test_in_motion_init_keeps_icp_converged(self):
        cfg, gt, outs = self._drive_fast()
        used = np.asarray([o.used_imu for o in outs])
        assert used.any(), "IMU never initialized in the drive"
        first = int(np.argmax(used))
        # init genuinely completed IN MOTION: the vehicle was metres from
        # the origin when the EKF took over
        assert np.linalg.norm(np.asarray(outs[first].pose)[:3, 3]) > 2.0
        # seeded init + online gravity: every post-init registration
        # CONVERGES below the iteration cap (the teleport/frozen-gravity
        # failures saturate at the cap, non-converged); final scan excluded
        # (clamped-pose render artifact, see test_in_motion_init_fast_path)
        for i in range(first, len(outs) - 1):
            assert bool(outs[i].icp_converged), (
                f"scan {i} not converged ({int(outs[i].icp_iterations)} it)"
            )
            assert int(outs[i].icp_iterations) < cfg.icp.max_iterations
        # and the trajectory tracks ground truth through the handover
        # (LIO poses are at scan END — compare against gt[i+1])
        gt_rel = np.linalg.inv(gt[0]) @ gt[len(outs) - 1]
        err = np.linalg.norm(np.asarray(outs[-1].pose)[:3, 3] - gt_rel[:3, 3])
        assert err < 0.6, f"final tracking error {err:.3f} m"

    def test_slow_in_motion_init_no_teleport(self):
        """Init completing at LOW speed (below the old 2.5 m/s "moving"
        gate) must still pin the EKF to the odometry frame: the round-5
        drive found a 1.2 m/s init falling into the at-rest seed branch,
        which left the nominal state at the origin while the vehicle was
        ~1.5 m away — the next guess teleported (63 ICP iterations, 1.6 m
        error) and velocity needed ~10 scans to recover from the zeroed
        seed (models/ekf.initialize_from_odometry; PARITY.md #26)."""
        cfg, gt, outs = self._drive_fast(speed=1.2)
        used = np.asarray([o.used_imu for o in outs])
        assert used.any()
        first = int(np.argmax(used))
        # the handoff scan must not teleport: error vs ground truth stays
        # in the odometry's own noise band, and ICP converges quickly
        gt_rel = np.linalg.inv(gt[0]) @ gt[min(first + 1, len(gt) - 1)]
        err = np.linalg.norm(
            np.asarray(outs[first].pose)[:3, 3] - gt_rel[:3, 3]
        )
        assert err < 0.4, f"post-seed scan teleported: {err:.3f} m"
        assert int(outs[first].icp_iterations) < cfg.icp.max_iterations
        # the seeded velocity is the odometry's, not zero
        pos = gt[:, :3, 3]
        v_gt = np.gradient(pos, 0.1 * np.arange(len(gt)), axis=0)
        v_err = np.linalg.norm(
            np.asarray(outs[first].velocity)
            - v_gt[min(first + 1, len(gt) - 1)]
        )
        assert v_err < 0.5, f"seed velocity error {v_err:.2f} m/s"

    def test_gravity_converges_and_velocity_bounded(self):
        cfg, gt, outs = self._drive_fast()
        used = np.asarray([o.used_imu for o in outs])
        first = int(np.argmax(used))
        # ground-truth world velocity at scan END (finite difference)
        pos = gt[:, :3, 3]
        v_gt = np.gradient(pos, 0.1 * np.arange(len(gt)), axis=0)
        errs = np.asarray([
            np.linalg.norm(
                np.asarray(outs[i].velocity) - v_gt[min(i + 1, len(gt) - 1)]
            )
            for i in range(first, len(outs))
        ])
        # the frozen-gravity filter reached |v err| > 5 m/s by the end of
        # this drive; the coupled filter must CONVERGE, not grow
        assert errs[-1] < 0.5, f"final velocity error {errs[-1]:.2f} m/s"
        assert errs[-1] < errs[0] + 0.1, (
            f"velocity error grew over the drive: {np.round(errs, 2)}"
        )
