"""Config overrides (YAML/dict) and the CLI driver on synthetic data."""

import json

import numpy as np
import pytest

from lidar_imu_slam_tpu import config as cfgmod
from lidar_imu_slam_tpu import config_io


class TestConfigIo:
    def test_from_dict_nested(self):
        cfg = config_io.from_dict({"map": {"voxel_size": 0.25}, "icp": {"deskew": True}})
        assert cfg.map.voxel_size == 0.25
        assert cfg.icp.deskew is True
        assert cfg.lidar.max_range == 100.0  # untouched default

    def test_unknown_key_rejected(self):
        with pytest.raises(KeyError, match="unknown config key 'voxelsize'"):
            config_io.from_dict({"map": {"voxelsize": 0.25}})

    def test_yaml_roundtrip(self, tmp_path):
        p = tmp_path / "cfg.yaml"
        p.write_text("map:\n  voxel_size: 2.0\nekf:\n  lidar_pose_trail: 6\n")
        cfg = config_io.from_yaml(str(p))
        assert cfg.map.voxel_size == 2.0
        assert cfg.ekf.lidar_pose_trail == 6
        assert cfg.ekf.state_dim == 30 + 42

    def test_preserves_types(self):
        cfg = config_io.from_dict({"icp": {"max_iterations": 7.0}})
        assert cfg.icp.max_iterations == 7
        assert isinstance(cfg.icp.max_iterations, int)


class TestSplitScan:
    def test_segments_cover_and_normalize(self):
        import jax.numpy as jnp

        from lidar_imu_slam_tpu.config import LidarConfig
        from lidar_imu_slam_tpu.ops import preprocess

        xyz = np.tile([[10.0, 0, 0]], (100, 1)).astype(np.float32)
        t = 5.0 + np.linspace(0, 0.1, 100)
        raw = preprocess.pack_raw_scan(xyz, time=t, stamp=5.0, max_points=128)
        scan = preprocess.preprocess_scan(
            raw, LidarConfig(max_range=50, min_range=1, max_points=128)
        )
        segs = preprocess.split_scan(scan, 4)
        assert len(segs) == 4
        total = sum(int(jnp.sum(s.mask)) for s in segs)
        assert total == 100
        for s in segs:
            tau = np.asarray(s.tau)[np.asarray(s.mask)]
            assert tau.min() >= 0.0 and tau.max() <= 1.0 + 1e-6
        # segment time ranges are increasing and abut
        assert float(segs[1].t_begin) > float(segs[0].t_begin)
        assert float(segs[3].t_end) <= float(scan.t_end) + 1e-9


class TestCli:
    def test_synthetic_run(self, tmp_path, capsys):
        from lidar_imu_slam_tpu import cli

        out = tmp_path / "traj.tum"
        rc = cli.main(
            [
                "--synthetic", "6",
                "--preset", "default",
                "--config", str(_write_cfg(tmp_path)),
                "--out", str(out),
            ]
        )
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["scans"] == 6
        assert "ate_rmse_m" in summary
        lines = out.read_text().strip().splitlines()
        assert len(lines) == 6 and len(lines[0].split()) == 8


def _write_cfg(tmp_path):
    p = tmp_path / "small.yaml"
    p.write_text(
        "lidar:\n  max_points: 8192\n  min_range: 0.5\n  max_range: 30.0\n"
        "map:\n  voxel_size: 0.5\n  capacity: 16384\n  max_range: 30.0\n"
        "icp:\n  max_map_points: 8192\n  max_source_points: 2048\n"
    )
    return p


def test_gn_backend_values():
    from lidar_imu_slam_tpu import config as cfgmod

    assert cfgmod.kitti_64beam().icp.gn_backend == "fused"
    assert cfgmod.IcpConfig().gn_backend == "xla"
    with pytest.raises(ValueError, match="gn_backend"):
        cfgmod.IcpConfig(gn_backend="pallas")
