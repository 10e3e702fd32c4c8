"""Smoke test of the odometry step on one GPU, at the full width of the
`kitti_64beam` deployment (HDL-64E: 131,072 points per scan, 1 m voxels,
map capacity 2^18, 4,096 ICP source points, 8-voxel neighbourhood).

    python chip_smoke.py           # phases 1-4 on one GPU
    python chip_smoke.py --four    # only the four-GPU path and its controls

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit, JAX's view of the device.
     Refuses to run without a GPU — there is no CPU fallback.
  2. lidar-only: 30 rolling-shutter scans through
     `host.runner.OdometryRunner.run` (the `cli --preset kitti` path),
     twice; ATE against the synthetic ground truth and agreement with the
     committed CPU trajectory (`chip_smoke_reference.json`).
  3. LIO: 40 scans (20 static for the IMU initialisation) with a 100 Hz
     IMU stream through `LioRunner.run_lio`, default 170-dim EKF.
  4. kernels at real widths against the plain f64 references: the fused GN
     (4,096 queries x 80 candidates) against `icp_registration`, the
     pose_pre/pose_post chains against the f64 chain, and the f32 matrix
     products left in the compiled step.
  --four: dp streams, a map sharded 4 ways and the 2x2 grid, each against
     the same work on one card.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
`tools/smoke_reference.py` regenerates the CPU reference.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REFERENCE_FILE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "chip_smoke_reference.json"
)
LIDAR_SCANS = 30
LIO_SCANS, LIO_STATIC = 40, 20
POINTS_PER_SCAN = 131072
# accuracy bounds against the synthetic ground truth (displacement ATE):
# a lost track moves poses by metres, a working one by centimetres
LIDAR_ATE_BOUND_M = 0.10
LIO_ATE_BOUND_M = 0.30
# per-pose agreement with the committed CPU trajectory: both runs follow
# the same math, but the GPU sums its reductions in another order, so each
# registration lands micrometres apart and the map absorbs slightly
# different points; the first H100 run differed by at most 1.3 mm and
# 53 urad. The bounds leave ~4x that margin and stay far below the ICP
# noise (~1 cm).
REF_TRANS_TOL_M = 5e-3
REF_ROT_TOL_RAD = 2.5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(devices) -> None:
    """Refuse to run unless JAX's first device is a GPU."""
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found platform {platform!r}"
        )


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def kitti_cfg():
    from lidar_imu_slam_tpu import config

    return config.kitti_64beam()


def make_drive(n_scans: int, n_static: int = 0):
    """Rolling-shutter HDL-64E scans of a seeded synthetic street (the
    bench's drive): returns (scan messages, ground-truth poses)."""
    from lidar_imu_slam_tpu.host import synthetic

    world = synthetic.make_world(
        seed=0, n_points=600_000, extent=(160.0, 40.0, 12.0)
    )
    gt = synthetic.make_trajectory(
        n_poses=n_scans, speed=8.0, yaw_rate=0.01, dt=0.1, n_static=n_static
    )
    msgs = []
    for i in range(n_scans):
        pts, rel = synthetic.render_scan_rolling(
            world, gt[i], gt[min(i + 1, n_scans - 1)], 0.1,
            POINTS_PER_SCAN, 2.5, 80.0, noise=0.02, seed=i,
        )
        msgs.append({"xyz": pts, "time": i * 0.1 + rel, "stamp": i * 0.1})
    return msgs, gt


def run_lidar(cfg, msgs):
    from lidar_imu_slam_tpu.host.runner import OdometryRunner

    runner = OdometryRunner(cfg).run(iter(msgs))
    return np.stack(runner.poses), runner


def run_lio(cfg, msgs, gt):
    from lidar_imu_slam_tpu.host import synthetic
    from lidar_imu_slam_tpu.host.runner import LioRunner

    times, gyros, accs = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)
    imu = np.concatenate([times[:, None], gyros, accs], axis=1)
    runner = LioRunner(cfg).run_lio(iter(msgs), imu)
    used = np.asarray([r["used_imu"] for r in runner.metrics.records])
    return np.stack(runner.poses), used


def compare_to_reference(name: str, poses: np.ndarray) -> None:
    with open(REFERENCE_FILE) as f:
        ref = np.asarray(json.load(f)[name], np.float64)
    assert ref.shape == poses.shape, (name, ref.shape, poses.shape)
    dt = np.linalg.norm(poses[:, :3, 3] - ref[:, :3, 3], axis=-1)
    rel = np.einsum("nji,njk->nik", ref[:, :3, :3], poses[:, :3, :3])
    # angle from the skew part: arccos of the trace cannot resolve angles
    # below ~5e-4 rad in matrices rounded to f32
    skew = np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                     rel[:, 1, 0] - rel[:, 0, 1]], axis=-1) / 2.0
    dr = np.arcsin(np.clip(np.linalg.norm(skew, axis=-1), 0.0, 1.0))
    log(f"{name}: vs CPU reference max |dt| {dt.max():.3e} m, "
        f"max |dR| {dr.max():.3e} rad")
    assert dt.max() < REF_TRANS_TOL_M, (name, dt.max())
    assert dr.max() < REF_ROT_TOL_RAD, (name, dr.max())


def phase_lidar(check_reference: bool = True):
    from lidar_imu_slam_tpu.models import kiss_icp
    from lidar_imu_slam_tpu.utils import trajectory

    cfg = kitti_cfg()
    msgs, gt = make_drive(LIDAR_SCANS)
    t0 = time.perf_counter()
    poses, runner = run_lidar(cfg, msgs)
    log(f"lidar: {len(poses)} scans in {time.perf_counter() - t0:.1f} s "
        "(first scan includes compilation)")
    poses2, _ = run_lidar(cfg, msgs)
    log(f"lidar: second run bitwise identical: "
        f"{bool(np.array_equal(poses, poses2))}, max |diff| "
        f"{np.abs(poses - poses2).max():.3e}")
    ate = trajectory.ate_displacement(poses, gt, shift=0.5)
    iters = [r["icp_iterations"] for r in runner.metrics.records]
    log(f"lidar: ATE {ate:.4f} m (bound {LIDAR_ATE_BOUND_M}), "
        f"ICP iterations mean {np.mean(iters):.2f}")
    assert np.isfinite(poses).all()
    assert ate < LIDAR_ATE_BOUND_M, ate
    if check_reference:
        compare_to_reference("lidar", poses)

    # memory of the compiled step, and any f32 matrix product left in it
    from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan

    state = kiss_icp.init_state(cfg)
    scan = preprocess_scan(
        pack_raw_scan(msgs[0]["xyz"], time=msgs[0]["time"], stamp=0.0,
                      max_points=cfg.lidar.max_points), cfg.lidar,
    )
    compiled = kiss_icp.register_frame_step.lower(state, scan, cfg).compile()
    log(f"lidar step memory_analysis: {compiled.memory_analysis()}")
    f32_products = f32_matmuls(compiled.as_text())
    log(f"lidar step: {len(f32_products)} f32 dot/convolution ops")
    for line in f32_products:
        log(f"  f32 product: {line[:200]}")
    return poses


def f32_matmuls(hlo_text: str) -> list:
    """Lines of an HLO module that are f32 matrix products or convolutions
    (plain or lowered to a cuBLAS/cuDNN call): on this card they may run
    in TF32 unless their precision says otherwise."""
    keys = (" dot(", " convolution(", "__cublas$gemm", "__cublas$lt$matmul",
            "__cudnn$conv")
    out = []
    for line in hlo_text.splitlines():
        if any(k in line for k in keys) and "f32[" in line.split("=", 1)[-1]:
            out.append(line.strip())
    return out


def phase_lio(check_reference: bool = True):
    from lidar_imu_slam_tpu.utils import trajectory

    cfg = kitti_cfg()
    msgs, gt = make_drive(LIO_SCANS, n_static=LIO_STATIC)
    t0 = time.perf_counter()
    poses, used = run_lio(cfg, msgs, gt)
    log(f"lio: {len(poses)} scans in {time.perf_counter() - t0:.1f} s, "
        f"IMU used on {int(used.sum())} scans, "
        f"EKF dim {cfg.ekf.state_dim}")
    ate = trajectory.ate_displacement(poses, gt, shift=1.0)
    log(f"lio: ATE {ate:.4f} m (bound {LIO_ATE_BOUND_M})")
    assert np.isfinite(poses).all()
    assert used.sum() > 0, "the IMU never initialised"
    assert ate < LIO_ATE_BOUND_M, ate
    if check_reference:
        compare_to_reference("lio", poses)
    return poses


def _gn_map(offset):
    import jax.numpy as jnp

    from lidar_imu_slam_tpu.config import MapConfig
    from lidar_imu_slam_tpu.ops import voxel_map

    cfg = MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 15,
                    neighborhood=8)
    rng = np.random.default_rng(0)
    world = (rng.uniform(-18, 18, size=(30000, 3))
             + np.asarray(offset)).astype(np.float32)
    m = voxel_map.insert(
        voxel_map.create(cfg), jnp.asarray(world), jnp.ones(len(world), bool),
        cfg,
    )
    return m, world, cfg


def phase_kernels():
    import jax.numpy as jnp

    from lidar_imu_slam_tpu.ops import icp as icp_ops

    # fused GN at 4,096 queries x 80 candidates (8 voxels x 10 points)
    for offset in ((0.0, 0.0, 0.0), (300.0, -250.0, 40.0)):
        m, world, mcfg = _gn_map(offset)
        assert 8 * mcfg.packed_width == 80
        t_true = np.array([0.25, -0.15, 0.1])
        src = jnp.asarray((world[:4096] - t_true).astype(np.float32))
        mask = jnp.ones(4096, bool)
        eye = jnp.eye(4, dtype=jnp.float64)
        ref = icp_ops.icp_registration(
            m, src, mask, eye, 1.5, 0.5, mcfg, 30, 1e-5)
        got = icp_ops.icp_registration_fused(
            m, src, mask, eye, 1.5, 0.5, mcfg, 30, 1e-5)
        d = np.abs(np.asarray(got.pose) - np.asarray(ref.pose)).max()
        log(f"fused GN 4096x80 at offset {offset}: max |pose - f64| {d:.3e} "
            f"(bound 1e-3), iterations {int(got.iterations)}")
        assert bool(got.converged)
        assert d < 1e-3, d

    check_pose_chain()


def check_pose_chain() -> None:
    """pose_pre / pose_post rows against the f64 chain (the tolerances of
    tests/test_pose_chain.py)."""
    import jax.numpy as jnp

    from lidar_imu_slam_tpu.models import kiss_icp
    from lidar_imu_slam_tpu.ops import icp as icp_ops
    from lidar_imu_slam_tpu.ops import lie, pose_chain

    def rand_pose(rng, scale_t=5.0, scale_r=0.3):
        xi = np.concatenate(
            [rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r])
        return np.asarray(lie.se3_exp(jnp.asarray(xi)))

    def split(x):
        x = jnp.asarray(x, jnp.float64)
        hi = x.astype(jnp.float32)
        return hi, (x - hi.astype(jnp.float64)).astype(jnp.float32)

    worst_pre = 0.0
    for num_poses in (0, 1, 2, 5):
        rng = np.random.default_rng(10 + num_poses)
        pose_prev = rand_pose(rng)
        pose = pose_prev @ rand_pose(rng, 0.3, 0.05)
        thr = icp_ops.ThresholdState(
            jnp.float64(1.234), jnp.int32(7),
            jnp.asarray(rand_pose(rng, 0.05, 0.01)))
        st = kiss_icp.KissState(
            None, jnp.asarray(pose), jnp.asarray(pose_prev),
            jnp.asarray(rand_pose(rng)), jnp.int32(num_poses), thr)
        moved = kiss_icp.has_moved(st, 0.1)
        guess_ref = np.asarray(lie.compose(
            jnp.where(st.num_poses == 0, jnp.eye(4, dtype=jnp.float64),
                      st.pose),
            kiss_icp.get_prediction_model(st)))
        _, sigma_ref = icp_ops.compute_threshold(thr, moved, 2.0, 0.1, 30.0)
        vec = jnp.concatenate([st.pose.reshape(16), st.pose_prev.reshape(16),
                               st.first_pose.reshape(16),
                               thr.model_error_sq.reshape(1)])
        hi, lo = split(vec)
        row = np.asarray(pose_chain.pose_pre(
            hi, lo, thr.model_deviation.reshape(16).astype(jnp.float32),
            jnp.stack([st.num_poses, thr.num_samples]),
            min_motion_th=0.1, initial_threshold=2.0, max_range=30.0,
            deskew_on=True))
        guess = np.eye(4)
        guess[:3, :3] = row[0:9].reshape(3, 3)
        guess[:3, 3] = row[9:12].astype(np.float64) + row[12:15]
        d = np.abs(guess - guess_ref).max()
        worst_pre = max(worst_pre, d)
        assert d < 2e-6, (num_poses, d)
        assert bool(row[16] > 0.5) == bool(moved)
        assert abs(row[15] - float(sigma_ref)) <= 3e-4 * abs(float(sigma_ref))
    log(f"pose_pre: max |guess - f64| {worst_pre:.3e} (bound 2e-6)")

    worst_post = 0.0
    for diverge in (False, True):
        rng = np.random.default_rng(4 + diverge)
        guess = rand_pose(rng)
        corr = np.asarray(lie.se3_exp(jnp.asarray(np.concatenate(
            [rng.normal(size=3) * (20.0 if diverge else 0.05),
             rng.normal(size=3) * 0.02]))))
        pose_icp = corr @ guess
        model_dev = np.linalg.inv(guess) @ pose_icp
        div_ref = np.linalg.norm(model_dev[:3, 3]) > 10.0
        new_ref = np.asarray(lie.orthonormalize(
            jnp.asarray(guess if div_ref else pose_icp)))
        ch, cl = split(corr[:3, 3])
        gh, gl = split(guess[:3, 3])
        prow = np.asarray(pose_chain.pose_post(jnp.concatenate([
            jnp.asarray(corr[:3, :3].reshape(9), jnp.float32), ch, cl,
            jnp.asarray(guess[:3, :3].reshape(9), jnp.float32), gh, gl,
        ]), max_model_deviation=10.0))
        assert bool(prow[15] > 0.5) == div_ref
        dR = np.abs(prow[0:9].reshape(3, 3) - new_ref[:3, :3]).max()
        dt = np.abs(prow[9:12].astype(np.float64) + prow[12:15]
                    - new_ref[:3, 3]).max()
        worst_post = max(worst_post, dt)
        assert dR < 3e-7 and dt < 2e-6, (diverge, dR, dt)
    log(f"pose_post: max |t - f64| {worst_post:.3e} (bound 2e-6)")


def phase_four():
    """dp streams, a 4-way sharded map and the 2x2 dp x mp grid, each
    compared with the same work on one card."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lidar_imu_slam_tpu import parallel
    from lidar_imu_slam_tpu.models import kiss_icp
    from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan
    from lidar_imu_slam_tpu.parallel import sharded_map

    devices = jax.devices()
    assert len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}"
    n_steps = 4
    cfg = kitti_cfg()
    msgs, _ = make_drive(n_steps + 3)
    with jax.default_device(devices[0]):
        scans = [
            preprocess_scan(pack_raw_scan(
                m["xyz"], time=m["time"], stamp=m["stamp"],
                max_points=cfg.lidar.max_points), cfg.lidar)
            for m in msgs
        ]

    def stack(xs):
        return jax.tree.map(lambda *a: jnp.stack(a), *xs)

    def max_dt(a, b):
        return float(np.abs(np.asarray(a)[..., :3, 3]
                            - np.asarray(b)[..., :3, 3]).max())

    # dp: 4 streams (staggered by one scan), one per card
    bcfg = parallel.streams.batch_config(cfg)
    mesh = parallel.mesh.stream_mesh(devices)
    step = parallel.mesh.sharded_multistream_step(mesh, bcfg)
    states = parallel.mesh.shard_streams(
        parallel.streams.init_batched_state(bcfg, 4), mesh)
    with jax.default_device(devices[0]):
        ctrl = parallel.streams.init_batched_state(bcfg, 4)
    worst = 0.0
    for k in range(n_steps):
        batch = stack([scans[k + s] for s in range(4)])
        states, poses, metrics = step(
            states, parallel.mesh.shard_streams(batch, mesh))
        ctrl, outs = parallel.streams.batched_register_frame_jit(
            ctrl, jax.device_put(batch, devices[0]), bcfg)
        worst = max(worst, max_dt(poses, outs.pose))
    assert np.isfinite(np.asarray(poses)).all()
    assert int(metrics.total_correspondences) > 0
    log(f"four dp: 4 streams x {n_steps} steps, max |dt| vs one card "
        f"{worst:.3e} m")
    assert worst < 1e-4, worst

    # mp: one stream, map sharded 4 ways vs one map of 4x capacity on one
    # card (same fixed-unroll f64 schedule as the sharded step, which does
    # not deskew)
    scfg = cfg.replace(
        map=dataclasses.replace(cfg.map, capacity=cfg.map.capacity // 4),
        icp=dataclasses.replace(cfg.icp, gn_backend="xla", deskew=False,
                                batch_unroll_outer=2, batch_unroll_inner=4),
    )
    ccfg = scfg.replace(map=dataclasses.replace(
        scfg.map, capacity=scfg.map.capacity * 4))
    mp_mesh = parallel.mesh.stream_mesh(devices, axis="mp")
    sstate = sharded_map.shard_state(
        sharded_map.init_state(scfg, 4), mp_mesh, axis="mp")
    with jax.default_device(devices[0]):
        cstate = kiss_icp.init_state(ccfg)
    worst = 0.0
    for k in range(n_steps):
        sstate, pose, smetrics = sharded_map.register_frame_jit(
            sstate, scans[k], scfg, 4)
        cstate, out = kiss_icp.register_frame_jit(cstate, scans[k], ccfg)
        worst = max(worst, max_dt(pose, out.pose))
    assert int(smetrics["drops"]) == 0
    log(f"four mp: map over 4 shards, {int(smetrics['map_voxels'])} voxels, "
        f"max |dt| vs one map of 4x capacity {worst:.3e} m")
    assert worst < 1e-4, worst

    # dp x mp: 2 streams, each map sharded over 2 cards, vs one-card
    # single maps of 2x capacity
    gcfg = scfg.replace(map=dataclasses.replace(
        scfg.map, capacity=cfg.map.capacity // 2))
    g_ctrl_cfg = gcfg.replace(map=dataclasses.replace(
        gcfg.map, capacity=gcfg.map.capacity * 2))
    grid = parallel.mesh.grid_mesh(2, 2, devices)
    mstate = sharded_map.shard_multi_state(
        sharded_map.init_multi_state(gcfg, 2, 2), grid)
    with jax.default_device(devices[0]):
        gctrl = [kiss_icp.init_state(g_ctrl_cfg) for _ in range(2)]
    worst = 0.0
    for k in range(n_steps):
        pair = [scans[k], scans[k + 1]]
        mstate, mposes, _ = sharded_map.batched_register_frame_jit(
            mstate, jax.device_put(stack(pair), NamedSharding(grid, P("dp"))),
            gcfg, 2)
        for s in range(2):
            gctrl[s], out = kiss_icp.register_frame_jit(
                gctrl[s], pair[s], g_ctrl_cfg)
            worst = max(worst, max_dt(np.asarray(mposes)[s], out.pose))
    log(f"four dp x mp: 2 streams x 2 shards, max |dt| vs one card "
        f"{worst:.3e} m")
    assert worst < 1e-4, worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path and its controls")
    args = ap.parse_args(argv)

    import jax

    from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    require_gpu(devices)
    log(card_line())
    log(f"jax {jax.__version__}, platform {devices[0].platform}, "
        f"device_kind {devices[0].device_kind}, count {len(devices)}")
    log(f"compile cache: {enable_compile_cache()}")

    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_lidar()
        log(f"[{time.perf_counter() - t0:.0f} s] lidar-only phase passed")
        phase_lio()
        log(f"[{time.perf_counter() - t0:.0f} s] LIO phase passed")
        phase_kernels()
        log(f"[{time.perf_counter() - t0:.0f} s] kernel phase passed")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
