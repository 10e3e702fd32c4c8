"""Command-line odometry driver (the `odom_run` analog,
reference src/odom_run.cpp:240-248 + launch/limu.launch).

    python -m lidar_imu_slam_tpu.cli --kitti <seq_dir> [--poses p.txt] \
        [--config cfg.yaml] [--lio] [--imu-topic /imu] [--out traj.tum]
    python -m lidar_imu_slam_tpu.cli --bag file.bag [--lidar-topic /points]
    python -m lidar_imu_slam_tpu.cli --synthetic 50    # self-test world
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LiDAR(-inertial) odometry")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--kitti", help="KITTI odometry sequence dir (velodyne/*.bin)")
    src.add_argument("--bag", help="rosbag v2.0 file")
    src.add_argument("--synthetic", type=int, metavar="N", help="N synthetic scans")
    p.add_argument("--poses", help="KITTI ground-truth poses txt (for ATE)")
    p.add_argument("--config", help="YAML config overrides")
    p.add_argument("--preset", choices=["default", "kitti", "livox"], default="kitti")
    p.add_argument("--lio", action="store_true", help="use the LiDAR-inertial pipeline")
    p.add_argument("--lidar-topic", default=None)
    p.add_argument("--imu-topic", default=None)
    p.add_argument("--out", default="trajectory.tum")
    p.add_argument("--format", choices=["tum", "kitti"], default="tum")
    p.add_argument("--metrics-out", default=None, help="per-scan metrics JSONL")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--max-scans", type=int, default=0)
    p.add_argument(
        "--save-clouds", default=None, metavar="DIR",
        help="write per-scan deskewed/keypoint clouds + the final map as "
        "PLY (the reference's frame/keypoints/local_map topics, "
        "odom_run.cpp:187-238)",
    )
    p.add_argument(
        "--save-clouds-every", type=int, default=10,
        help="scan stride for --save-clouds (each export costs a host sync)",
    )
    p.add_argument(
        "--loop-closure", action="store_true",
        help="enable the online keyframe backend (loop closure + pose-graph "
        "optimization); writes <out>.optimized alongside the raw trajectory",
    )
    return p


def _load_config(args):
    from . import config as cfgmod
    from . import config_io

    base = {
        "default": cfgmod.default,
        "kitti": cfgmod.kitti_64beam,
        "livox": cfgmod.livox_dense,
    }[args.preset]()
    if args.config:
        base = config_io.from_yaml(args.config, base)
    return base


def _kitti_scans(args):
    from .host import kitti

    seq = kitti.KittiSequence(args.kitti, poses_file=args.poses)
    msgs = iter(seq)
    if args.max_scans:
        import itertools

        msgs = itertools.islice(msgs, args.max_scans)
    return msgs, (seq.gt_poses if args.poses else None), seq.calib


def _bag_scans(args):
    from .host import rosbag

    lidar_msgs, imu_msgs = rosbag.read_sensor_streams(
        args.bag, lidar_topic=args.lidar_topic, imu_topic=args.imu_topic
    )
    if args.max_scans:
        lidar_msgs = lidar_msgs[: args.max_scans]

    def gen():
        for m in lidar_msgs:
            f = m["fields"]
            xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float32)
            time = None
            for name in ("time", "timestamp", "t"):
                if name in f:
                    time = np.asarray(f[name], np.float64)
                    break
            yield {
                "xyz": xyz,
                "time": time,
                "ring": f.get("ring"),
                "stamp": m["stamp"],
            }

    imu = (
        np.stack(
            [[s["stamp"], *s["gyro"], *s["acc"]] for s in imu_msgs]
        )
        if imu_msgs
        else np.zeros((0, 7))
    )
    return gen(), imu


def _synthetic_scans(args, cfg):
    from .host import synthetic

    world = synthetic.make_world(seed=0)
    n = args.synthetic
    gt = synthetic.make_trajectory(n_poses=n, speed=2.0, n_static=4)

    def gen():
        for i, pose in enumerate(gt):
            pts = synthetic.render_scan(
                world, pose, min(cfg.lidar.max_points, 60000),
                cfg.lidar.min_range, cfg.lidar.max_range, seed=i,
            )
            yield {"xyz": pts, "stamp": i * 0.1}

    return gen(), gt


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = _load_config(args)
    if args.loop_closure:
        import dataclasses

        cfg = cfg.replace(
            backend=dataclasses.replace(cfg.backend, enabled=True)
        )

    from .host.runner import LioRunner, OdometryRunner

    gt = None
    imu = None
    calib = {}
    if args.kitti:
        scans, gt, calib = _kitti_scans(args)
    elif args.bag:
        scans, imu = _bag_scans(args)
    else:
        scans, gt = _synthetic_scans(args, cfg)

    def progress(i, out):
        if i % 10 == 0:
            t = np.asarray(out.pose)[:3, 3]
            print(
                f"scan {i:5d}  t=({t[0]:8.2f} {t[1]:8.2f} {t[2]:6.2f})  "
                f"iters={int(out.icp_iterations):3d}",
                file=sys.stderr,
            )
        if args.save_clouds and i % max(args.save_clouds_every, 1) == 0:
            from .utils import cloud_io

            d = np.asarray(out.deskewed)[np.asarray(out.deskewed_mask)]
            cloud_io.write_ply(
                f"{args.save_clouds}/frame_{i:06d}.ply", d
            )
            if hasattr(out, "keypoints"):
                k = np.asarray(out.keypoints)[np.asarray(out.keypoints_mask)]
                cloud_io.write_ply(
                    f"{args.save_clouds}/keypoints_{i:06d}.ply", k
                )

    if args.lio and imu is not None and len(imu):
        runner = LioRunner(cfg, checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every)
        runner.run_lio(scans, imu, progress=progress)
    else:
        if args.lio:
            print("no IMU stream found; running lidar-only", file=sys.stderr)
        runner = OdometryRunner(cfg, checkpoint_dir=args.checkpoint_dir,
                                checkpoint_every=args.checkpoint_every)
        runner.run(scans, progress=progress)

    runner.write_trajectory(args.out, fmt=args.format)
    if args.metrics_out:
        runner.metrics.dump_jsonl(args.metrics_out)
    if args.save_clouds:
        from .utils import cloud_io

        map_state = (
            runner.state.map if hasattr(runner.state, "map")
            else runner.state.odo.map
        )
        cloud_io.export_map_ply(
            f"{args.save_clouds}/local_map.ply", map_state, cfg.map
        )
    if args.loop_closure and runner.backend is not None:
        from .utils import trajectory as traj_io

        opt = runner.optimized_poses()
        traj_io.write_tum(f"{args.out}.optimized", runner.stamps, list(opt))

    summary = {
        "scans": len(runner.poses),
        "p50_step_ms": round(runner.timer.p50 * 1e3, 2),
        "p95_step_ms": round(runner.timer.p95 * 1e3, 2),
        "trajectory": args.out,
    }
    if gt is not None and len(runner.poses) > 2:
        from .utils import trajectory as traj

        n = min(len(runner.poses), len(gt))
        est = np.stack(runner.poses)[:n]
        if args.kitti and "Tr" in calib:
            # KITTI GT is camera-frame; conjugate velodyne-frame estimates
            # with the Tr calibration before ATE/RPE
            from .host import kitti as kitti_mod

            est = kitti_mod.velo_to_cam_poses(est, calib)
        summary["ate_rmse_m"] = round(
            traj.ate_rmse(est, np.asarray(gt)[:n], align=True), 4
        )
        t_err, r_err = traj.rpe_rmse(est, gt[:n])
        summary["rpe_trans_m"] = round(t_err, 4)
        summary["rpe_rot_deg"] = round(r_err, 4)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
