"""Stage-by-stage timing of the fused odometry step on the GPU.

Times each stage of kiss_icp.register_frame at the kitti_64beam width in
isolation (separately jitted) so optimization effort lands where the
milliseconds are. Every timed window ends in `jax.block_until_ready`.

    python tools/profile_step.py [n_iters]
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lidar_imu_slam_tpu import config as cfgmod  # noqa: E402
from lidar_imu_slam_tpu.host import synthetic  # noqa: E402
from lidar_imu_slam_tpu.models import kiss_icp  # noqa: E402
from lidar_imu_slam_tpu.ops import icp as icp_ops  # noqa: E402
from lidar_imu_slam_tpu.ops import icp_gn, voxel_map  # noqa: E402
from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan  # noqa: E402
from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def timeit(name, fn, *args, n=10):
    """fn is jitted; time n back-to-back calls ending in one sync."""
    out = jax.block_until_ready(fn(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:40s} {dt * 1e3:8.3f} ms")
    return out


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("tools/profile_step.py measures a GPU; none found")
    enable_compile_cache()
    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    cfg = cfgmod.kitti_64beam()
    pts_n = cfg.lidar.max_points

    world = synthetic.make_world(seed=0, n_points=600_000, extent=(160.0, 40.0, 12.0))
    gt = synthetic.make_trajectory(n_poses=12, speed=8.0, yaw_rate=0.01, dt=0.1)
    pre = jax.jit(lambda raw: preprocess_scan(raw, cfg.lidar))
    raws, scans = [], []
    for i, pose in enumerate(gt):
        pts = synthetic.render_scan(world, pose, pts_n, 2.5, 80.0, noise=0.02, seed=i)
        raw = pack_raw_scan(pts, time=synthetic.azimuth_times(pts, i * 0.1),
                            stamp=i * 0.1, max_points=pts_n)
        raws.append(raw)
        scans.append(jax.block_until_ready(pre(raw)))

    # warm state (a few steps) so stage timings see realistic occupancy
    state = kiss_icp.init_state(cfg)
    for i in range(8):
        state, out = kiss_icp.register_frame_jit(state, scans[i], cfg)
    print(f"map voxels after warmup: {int(out.map_voxels)}")
    raw, scan = raws[9], scans[9]

    timeit("register_frame (full step)",
           jax.jit(lambda s, sc: kiss_icp.register_frame(s, sc, cfg)),
           state, scan, n=n_iters)
    timeit("preprocess_scan", pre, raw, n=n_iters)

    # downsamples at the guess pose (world frame, like the trunk)
    g = timeit(
        "fused_downsample (131k -> 32k)",
        jax.jit(lambda p, m: voxel_map.fused_downsample(
            p, m, cfg.map.voxel_size, cfg.icp.max_map_points)),
        scan.xyz, scan.mask, n=n_iters)
    src, src_mask, _, _ = timeit(
        "first_point_per_voxel (32k -> 4k)",
        jax.jit(lambda p, m: voxel_map.first_point_per_voxel(
            p, m, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points)),
        g.points, g.mask, n=n_iters)

    anchor = jnp.sum(jnp.where(src_mask[:, None], src, 0.0), 0) / jnp.maximum(
        jnp.sum(src_mask), 1)
    cand = timeit(
        "candidate fetch (packed, 1 round)",
        jax.jit(lambda q, m, a: voxel_map.gather_candidate_planes_packed(
            state.map, q, m, cfg.map, a)),
        src, src_mask, anchor, n=n_iters)
    q = (src - anchor).T.astype(jnp.float32)
    scal = jnp.asarray([0.3, 1.0, 1e-4, 20, 2.0, 0.25], jnp.float32)
    carry = jnp.concatenate([jnp.eye(3, dtype=jnp.float32).reshape(9),
                             jnp.zeros(6, jnp.float32),
                             anchor.astype(jnp.float32)])
    timeit(f"fused GN ({cfg.icp.fused_inner} iterations, 1 round)",
           jax.jit(lambda *a: icp_gn.fused_gn_carry(*a, cfg.icp.fused_inner)),
           q, src_mask.astype(jnp.float32), cand, scal, carry, n=n_iters)
    eye9 = jnp.eye(3, dtype=jnp.float32).reshape(9)
    z3 = jnp.zeros(3, jnp.float32)
    res = timeit(
        "fused ICP (full while loop)",
        jax.jit(lambda p, m: icp_ops.icp_registration_fused_pair(
            state.map, p, m, eye9, z3, z3, 2.0, 0.3, cfg.map,
            cfg.icp.max_iterations, cfg.icp.estimation_threshold,
            n_inner=cfg.icp.fused_inner)),
        src, src_mask, n=n_iters)
    print(f"  iters={int(res[3])}, corr={int(res[4])}")

    keys = voxel_map.pack_key(voxel_map.voxel_of(g.points, cfg.map.voxel_size))
    timeit("insert_grouped (32k pts)",
           jax.jit(lambda m, gg, k: voxel_map.insert_grouped(m, gg, cfg.map, keys=k)),
           state.map, g, keys, n=n_iters)
    timeit("evict_far",
           jax.jit(lambda m, o: voxel_map.evict_far(m, o, cfg.map)),
           state.map, jnp.asarray(np.asarray(gt[9][:3, 3], np.float32)),
           n=n_iters)


if __name__ == "__main__":
    main()
