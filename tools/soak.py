"""Long-sequence soak: N scans at KITTI scale over a long synthetic course.

Exercises what short tests cannot: sustained eviction churn as the map
window slides, tombstone accumulation + periodic rebuilds, hash-load drift,
and numerical stability over hundreds of compositions. Prints a JSON line.

    python tools/soak.py [n_scans]
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lidar_imu_slam_tpu import config as cfgmod  # noqa: E402
from lidar_imu_slam_tpu.host import synthetic  # noqa: E402
from lidar_imu_slam_tpu.host.runner import OdometryRunner  # noqa: E402
from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def main(n_scans: int = 300):
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit("tools/soak.py measures a GPU; none found")
    enable_compile_cache()
    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(
            num_scan_lines=64, max_points=131072, min_range=2.5, max_range=80.0
        ),
        map=cfgmod.MapConfig(
            voxel_size=1.0, max_range=80.0, capacity=1 << 17, neighborhood=8
        ),
        icp=cfgmod.IcpConfig(
            max_map_points=32768, max_source_points=4096,
            estimation_threshold=5e-4,
        ),
    )
    # long straight-ish course: the 80 m window slides continuously ->
    # sustained eviction + new-voxel allocation every scan
    world = synthetic.make_world(
        seed=0, n_points=4_000_000, extent=(2600.0, 60.0, 14.0)
    )
    world[:, 0] += 1250.0  # course runs +x from the origin
    gt = synthetic.make_trajectory(
        n_poses=n_scans, speed=8.0, yaw_rate=0.002, dt=0.1
    )

    def scan_stream():
        for i, p in enumerate(gt):
            yield {
                "xyz": synthetic.render_scan(
                    world, p, 131072, 2.5, 80.0, noise=0.02, seed=i
                ),
                "stamp": i * 0.1,
            }

    t0 = time.perf_counter()
    r = OdometryRunner(cfg).run(scan_stream())
    wall = time.perf_counter() - t0

    poses = np.stack(r.poses)
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    errs = np.linalg.norm(poses[:, :3, 3] - gt_rel[: len(poses), :3, 3], axis=1)
    dets = np.linalg.det(poses[:, :3, :3])
    drops = int(r.state.map.drops)
    tombs = int(r.state.map.tombstones)
    conv = [m.get("icp_converged") for m in r.metrics.records]
    print(
        json.dumps(
            {
                "scans": len(poses),
                "device": {"platform": d.platform, "kind": d.device_kind},
                "wall_s": round(wall, 1),
                "scans_per_sec_incl_preprocess": round(len(poses) / wall, 1),
                "final_err_m": round(float(errs[-1]), 3),
                "max_err_m": round(float(errs.max()), 3),
                "det_max_dev": float(np.abs(dets - 1.0).max()),
                "hash_drops": drops,
                "tombstones": tombs,
                "unconverged_scans": int(sum(1 for c in conv if c is False)),
                "distance_m": round(float(np.linalg.norm(poses[-1][:3, 3])), 1),
            }
        )
    )
    assert np.isfinite(poses).all()
    assert errs.max() < 5.0, "soak diverged"


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 300)
