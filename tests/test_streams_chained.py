"""Batched device-pipelined streams: vmap over the stream axis INSIDE a
lax.scan over scans (bench._bench_batched_chained's shape — the production
multi-stream feed). Guards that the chained program produces the same
trajectories as the eager batched loop, and that the static `time_source`
config (added so the rotation-model fallback is not traced into vmapped
programs) matches the runtime-cond default."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from lidar_imu_slam_tpu import config as cfgmod, parallel
from lidar_imu_slam_tpu.host import synthetic
from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan

CFG = cfgmod.PipelineConfig(
    lidar=cfgmod.LidarConfig(
        max_range=30.0, min_range=0.5, max_points=4096, sort_by_time=False,
        time_source="per_point",
    ),
    map=cfgmod.MapConfig(
        voxel_size=0.5, max_range=30.0, capacity=1 << 14, max_probes=16
    ),
    icp=cfgmod.IcpConfig(
        max_map_points=4096, max_source_points=1024, max_iterations=50
    ),
)
N_SCANS = 6
N_STREAMS = 2


def _make_raws():
    world = synthetic.make_world(seed=0, n_points=120_000, extent=(30.0, 10.0, 5.0))
    gt = synthetic.make_trajectory(n_poses=N_SCANS, speed=1.0, dt=0.1)
    raws = []
    for i, pose in enumerate(gt):
        pts = synthetic.render_scan(world, pose, 3500, 0.5, 30.0, noise=0.0, seed=i)
        raws.append(pack_raw_scan(
            pts, time=synthetic.azimuth_times(pts, i * 0.1), stamp=i * 0.1,
            max_points=4096,
        ))
    return raws, gt


def _batch_raw(raws, i):
    idx = [min(i + s, N_SCANS - 1) for s in range(N_STREAMS)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[raws[j] for j in idx])


class TestBatchedChained:
    def test_chained_matches_eager(self):
        raws, _ = _make_raws()
        bcfg = parallel.streams.batch_config(CFG)
        bpre = jax.jit(jax.vmap(lambda r: preprocess_scan(r, bcfg.lidar)))

        # eager batched loop (the reference shape: one dispatch per scan)
        states = parallel.streams.init_batched_state(bcfg, N_STREAMS)
        eager_poses = []
        for i in range(N_SCANS):
            states, outs = parallel.streams.batched_register_frame_jit(
                states, bpre(_batch_raw(raws, i)), bcfg
            )
            eager_poses.append(np.asarray(outs.pose))

        # chained: the same steps as one donated lax.scan program whose body
        # is a vmapped preprocess + register
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs), *[_batch_raw(raws, i) for i in range(N_SCANS)]
        )

        @functools.partial(jax.jit, donate_argnums=(0,))
        def run_chain(st, braws):
            def body(s, braw):
                sc = jax.vmap(lambda r: preprocess_scan(r, bcfg.lidar))(braw)
                s, out = parallel.streams.batched_register_frame(s, sc, bcfg)
                return s, out.pose

            return jax.lax.scan(body, st, braws)

        _, chained_poses = run_chain(
            parallel.streams.init_batched_state(bcfg, N_STREAMS), stacked
        )
        chained_poses = np.asarray(chained_poses)  # (N, S, 4, 4)

        for i in range(N_SCANS):
            np.testing.assert_allclose(
                chained_poses[i], eager_poses[i], rtol=0, atol=1e-9,
                err_msg=f"scan {i}",
            )

    def test_streams_track(self):
        raws, gt = _make_raws()
        bcfg = parallel.streams.batch_config(CFG)
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs), *[_batch_raw(raws, i) for i in range(N_SCANS)]
        )

        @jax.jit
        def run_chain(st, braws):
            def body(s, braw):
                sc = jax.vmap(lambda r: preprocess_scan(r, bcfg.lidar))(braw)
                s, out = parallel.streams.batched_register_frame(s, sc, bcfg)
                return s, out.pose

            return jax.lax.scan(body, st, braws)

        _, poses = run_chain(
            parallel.streams.init_batched_state(bcfg, N_STREAMS), stacked
        )
        # stream 0 sees the unshifted trajectory: its last pose must track
        gt_rel = np.linalg.inv(gt[0]) @ gt[-1]
        err = np.linalg.norm(np.asarray(poses)[-1, 0, :3, 3] - gt_rel[:3, 3])
        assert err < 0.15, err


class TestTimeSource:
    def test_per_point_matches_auto_when_times_present(self):
        raws, _ = _make_raws()
        auto_cfg = dataclasses.replace(CFG.lidar, time_source="auto")
        per_cfg = dataclasses.replace(CFG.lidar, time_source="per_point")
        a = preprocess_scan(raws[0], auto_cfg)
        b = preprocess_scan(raws[0], per_cfg)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_rotation_model_matches_auto_when_times_absent(self):
        world = synthetic.make_world(seed=1, n_points=60_000, extent=(30.0, 10.0, 5.0))
        pts = synthetic.render_scan(world, np.eye(4), 3500, 0.5, 30.0, noise=0.0, seed=0)
        raw = pack_raw_scan(pts, stamp=0.1, max_points=4096)  # no per-point time
        auto_cfg = dataclasses.replace(CFG.lidar, time_source="auto")
        rot_cfg = dataclasses.replace(CFG.lidar, time_source="rotation_model")
        a = preprocess_scan(raw, auto_cfg)
        b = preprocess_scan(raw, rot_cfg)
        # same math; the cond branch and the static path fuse differently,
        # so f32 results differ in the last ulp
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=0, atol=2e-6
            )
