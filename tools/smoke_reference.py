"""Regenerate `chip_smoke_reference.json`: the trajectories of chip_smoke's
lidar-only and LIO drives, computed on the CPU.

    python tools/smoke_reference.py [--out PATH]

Runs at the full kitti_64beam width, so it needs several GiB of host memory
and minutes of CPU time; chip_smoke.py compares each GPU pose against it.
"""

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=chip_smoke.REFERENCE_FILE)
    args = ap.parse_args()

    from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = chip_smoke.kitti_cfg()
    msgs, _ = chip_smoke.make_drive(chip_smoke.LIDAR_SCANS)
    lidar, _ = chip_smoke.run_lidar(cfg, msgs)
    print("lidar done", flush=True)
    msgs, gt = chip_smoke.make_drive(chip_smoke.LIO_SCANS,
                                     n_static=chip_smoke.LIO_STATIC)
    lio, _ = chip_smoke.run_lio(cfg, msgs, gt)
    with open(args.out, "w") as f:
        json.dump({
            "lidar": lidar.round(9).tolist(),
            "lio": lio.round(9).tolist(),
        }, f)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
