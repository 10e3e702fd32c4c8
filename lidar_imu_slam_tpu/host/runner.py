"""Host-side odometry runner: feed scans to the jitted step, collect poses,
checkpoint, report metrics.

Replaces the reference's ROS node main loop (reference src/odom_run.cpp:154-
185: 5 kHz polling over mutex-guarded deques) with a simple double-buffered
producer: scan k+1 is packed/preprocessed on the host while scan k runs on
the device. Adds what the reference lacks (SURVEY §5): per-scan metrics,
orbax checkpoint/exact-resume (the whole SLAM state is one pytree), and
trajectory export.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Callable, Iterable, Optional

import jax
import numpy as np

from ..config import PipelineConfig
from ..models import kiss_icp, lio
from ..ops.preprocess import pack_raw_scan, preprocess_scan
from ..utils.metrics import MetricsLog, StepTimer
from ..utils import trajectory


def checkpoint_save(path: str, state, step: int) -> None:
    """Orbax checkpoint of the full SLAM state pytree."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(os.path.join(path, f"step_{step:06d}"), state, force=True)
    ckpt.wait_until_finished()


def checkpoint_restore(path: str, abstract_state, step: int):
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    return ckpt.restore(os.path.join(path, f"step_{step:06d}"), abstract_state)


class OdometryRunner:
    """Drives the KISS-ICP (lidar-only) pipeline over a scan iterable."""

    def __init__(self, cfg: PipelineConfig, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0):
        self.cfg = cfg
        self.state = kiss_icp.init_state(cfg)
        self.poses: list[np.ndarray] = []
        self.stamps: list[float] = []
        self.metrics = MetricsLog()
        self.timer = StepTimer()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self._pre = jax.jit(lambda raw: preprocess_scan(raw, cfg.lidar))
        self.backend = None
        if cfg.backend.enabled:
            from .keyframes import OnlineBackend

            self.backend = OnlineBackend(cfg)
        self._chunk: list = []  # (scan_idx, pose, keypoints, mask) device refs

    def _backend_observe(self, i: int, out, final: bool = False) -> None:
        """Feed the online backend in chunks (one pose fetch per chunk)."""
        if self.backend is None:
            return
        if out is not None:
            self._chunk.append((i, out.pose, out.keypoints, out.keypoints_mask))
        if self._chunk and (len(self._chunk) >= self.cfg.backend.chunk or final):
            idxs = [c[0] for c in self._chunk]
            poses = np.stack([np.asarray(c[1]) for c in self._chunk])
            self.backend.observe_chunk(
                idxs, poses, [c[2] for c in self._chunk],
                [c[3] for c in self._chunk],
            )
            self._chunk = []
        if final and self.backend.kf_poses:
            self.backend.optimize()

    def optimized_poses(self) -> np.ndarray:
        """Loop-closure-corrected trajectory (raw odometry poses when the
        backend is disabled or found no loops)."""
        poses = np.stack(self.poses)
        if self.backend is None:
            return poses
        return self.backend.correct(poses)

    def _pack(self, scan_msg: dict):
        raw = pack_raw_scan(
            scan_msg["xyz"],
            time=scan_msg.get("time"),
            ring=scan_msg.get("ring"),
            stamp=scan_msg.get("stamp", 0.0),
            max_points=self.cfg.lidar.max_points,
        )
        return self._pre(raw)

    def _segments(self, scan, scan_index: int):
        """Frame splitting (reference split_clouds + MIN_SCAN_COUNT warmup
        gate, frame.cpp:5,64): one segment for the first `min_scan_count`
        scans, then `frame_split_num` independent sub-frames.

        Returns (segments, cfg): split segments are COMPACT (ceil(N/k)
        shape), so each sub-step costs ~1/k of a full step instead of the
        round-1 k-full-shape-steps behavior; they run under a derived
        config whose downsample budgets fit the segment shape."""
        from ..ops.preprocess import split_scan_compact

        n = self.cfg.lidar.frame_split_num
        if n <= 1 or scan_index < self.cfg.min_scan_count:
            return [scan], self.cfg
        return split_scan_compact(scan, n), self._segment_cfg()

    def _segment_cfg(self):
        if getattr(self, "_seg_cfg", None) is None:
            import dataclasses

            n = self.cfg.lidar.frame_split_num
            seg_len = -(-self.cfg.lidar.max_points // n)
            self._seg_cfg = self.cfg.replace(
                lidar=dataclasses.replace(self.cfg.lidar, max_points=seg_len),
                icp=dataclasses.replace(
                    self.cfg.icp,
                    max_map_points=min(self.cfg.icp.max_map_points, seg_len),
                    max_source_points=min(self.cfg.icp.max_source_points, seg_len),
                ),
            )
        return self._seg_cfg

    def _on_loop_back(self, scan_index: int) -> None:
        """Reset the SLAM state after a LiDAR loop-back (stamp regression).
        Already-collected poses/metrics are kept — the replayed section
        restarts odometry from identity."""
        import logging

        logging.getLogger(__name__).warning(
            "LiDAR loop back at scan %d: resetting SLAM state", scan_index
        )
        self.state = kiss_icp.init_state(self.cfg)

    def _maybe_rebuild(self, scan_index: int) -> None:
        """Compact the slab when eviction tombstones accumulate or the
        append-only bump cursor nears capacity (long sequences: evicted
        voxels reclaim their slots only through `rebuild`)."""
        if scan_index % 64 != 0 or scan_index == 0:
            return
        from ..ops import voxel_map

        cap = self.cfg.map.capacity
        tombs = int(self.state.map.tombstones)
        cursor = int(self.state.map.next_slot)
        if tombs > cap // 8 or (cursor > cap - cap // 4 and tombs > 0):
            self.state = self.state._replace(
                map=voxel_map.rebuild(self.state.map, self.cfg.map)
            )

    def run(self, scan_msgs: Iterable[dict], progress: Optional[Callable] = None,
            sync_every: int = 0):
        """Double-buffered loop: prefetch scan k+1 while scan k computes.

        Device outputs are collected WITHOUT a per-step host sync (a sync
        would idle the device between scans) and fetched in one pass at
        the end. `sync_every=N` forces a host
        sync every N scans (true per-scan latency numbers, checkpointing
        consistency); `progress` callbacks receive the device-side output
        pytree (fetch in the callback only if needed).
        """
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        it = iter(scan_msgs)

        def fetch_next():
            try:
                msg = next(it)
            except StopIteration:
                return None
            return pool.submit(self._pack, msg), float(msg.get("stamp", 0.0))

        nxt = fetch_next()
        i = 0
        prev_stamp = None
        dev_outs: list = []
        stamps: list = []
        while nxt is not None:
            fut, stamp = nxt
            scan = fut.result()
            nxt = fetch_next()
            if prev_stamp is not None and stamp < prev_stamp:
                # LiDAR loop-back (bag replay wrapped): reset the SLAM state
                # so the replay does not register against the stale map.
                # (The reference only clears its scan buffers and keeps the
                # stale map/poses, frame.cpp:16-22 — documented deviation,
                # PARITY.md.)
                self._on_loop_back(i)
            prev_stamp = stamp
            t0 = time.perf_counter()
            segs, seg_cfg = self._segments(scan, i)
            for seg in segs:
                # donating step: the ~160 MB map slabs update in place
                self.state, out = kiss_icp.register_frame_step(
                    self.state, seg, seg_cfg
                )
            if sync_every and (i + 1) % sync_every == 0:
                jax.block_until_ready(out.pose)
            dt = time.perf_counter() - t0
            if i > 0:
                self.timer.record(dt)
            # keep only the scalar outputs + pose on device (the point-cloud
            # fields would pin ~400 KB/scan of HBM over a long sequence)
            dev_outs.append(
                (out.pose, out.icp_iterations, out.num_correspondences,
                 out.residual_rms, out.sigma, out.map_voxels,
                 out.icp_converged, out.window_drops)
            )
            stamps.append(scan.t_begin)
            if (
                self.checkpoint_dir
                and self.checkpoint_every
                and (i + 1) % self.checkpoint_every == 0
            ):
                checkpoint_save(self.checkpoint_dir, self.state, i + 1)
            if progress:
                progress(i, out)
            self._backend_observe(i, out)
            self._maybe_rebuild(i)
            i += 1
        pool.shutdown()
        self._backend_observe(i, None, final=True)
        for i, (pose, iters, ncorr, rms, sigma, nvox, conv,
                wdrops) in enumerate(dev_outs):
            self.poses.append(np.asarray(pose))
            self.stamps.append(float(stamps[i]))
            self.metrics.append(
                i,
                icp_iterations=iters,
                num_correspondences=ncorr,
                residual_rms=rms,
                sigma=sigma,
                map_voxels=nvox,
                icp_converged=conv,
                window_drops=wdrops,
            )
        return self

    def write_trajectory(self, path: str, fmt: str = "tum") -> None:
        if fmt == "tum":
            trajectory.write_tum(path, self.stamps, self.poses)
        elif fmt == "kitti":
            trajectory.write_kitti(path, self.poses)
        else:
            raise ValueError(f"unknown format {fmt}")

    def ate_against(self, gt_poses, align: bool = True) -> float:
        return trajectory.ate_rmse(np.stack(self.poses), gt_poses, align=align)


class LioRunner(OdometryRunner):
    """Drives the full LiDAR-inertial pipeline: scans + per-scan IMU packets.

    First-class runner (round-2): same prefetch double-buffering, orbax
    checkpointing, map-rebuild maintenance and no-per-step-sync collection
    as `OdometryRunner.run`, plus the reference's host stream hygiene
    (lidar-imu time-offset latch, loop-back resets, IMU rate warning) via
    `stream_sync.StreamSynchronizer`.
    """

    def __init__(self, cfg: PipelineConfig, **kw):
        super().__init__(cfg, **kw)
        self.state = lio.init_state(cfg)

    def _maybe_rebuild(self, scan_index: int) -> None:
        if scan_index % 64 != 0 or scan_index == 0:
            return
        from ..ops import voxel_map

        cap = self.cfg.map.capacity
        tombs = int(self.state.odo.map.tombstones)
        cursor = int(self.state.odo.map.next_slot)
        if tombs > cap // 8 or (cursor > cap - cap // 4 and tombs > 0):
            odo = self.state.odo._replace(
                map=voxel_map.rebuild(self.state.odo.map, self.cfg.map)
            )
            self.state = self.state._replace(odo=odo)

    @staticmethod
    def _host_t_end(msg: dict) -> float:
        """Scan end time from the raw message (host side — reading the
        device Scan's t_end would force a device sync)."""
        t = msg.get("time")
        stamp = float(msg.get("stamp", 0.0))
        if t is not None and len(t):
            tmax = float(np.max(t))
            return tmax if tmax > stamp else stamp + tmax
        return stamp

    def _on_loop_back(self, scan_index: int) -> None:
        import logging

        logging.getLogger(__name__).warning(
            "LiDAR loop back at scan %d: resetting LIO state", scan_index
        )
        self.state = lio.init_state(self.cfg)

    def run_lio(self, scan_msgs: Iterable[dict], imu_stream, progress=None,
                sync_every: int = 0):
        """`imu_stream`: array-like of (t, gx, gy, gz, ax, ay, az) rows in
        arrival order. Samples are pushed through the stream synchronizer
        (offset shift + loop-back resets) and bucketed to the scan that
        covers them (reference buffers per scan segment, src/odom_run.hpp +
        sync_frame.hpp).

        First-class parity with `OdometryRunner.run` (round-3): frame
        splitting (`frame_split_num` with per-segment IMU sub-packets),
        online loop-closure backend observation, and a LiDAR loop-back
        reset of the whole LIO state (the synchronizer's flag was detected
        but dropped in round 2)."""
        from .stream_sync import StreamSynchronizer

        imu = np.asarray(imu_stream, np.float64)
        sync = StreamSynchronizer(self.cfg.imu)
        cursor = 0
        cap = self.cfg.imu.max_samples_per_scan

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        it = iter(scan_msgs)

        def fetch_next():
            try:
                msg = next(it)
            except StopIteration:
                return None
            return (pool.submit(self._pack, msg), self._host_t_end(msg),
                    float(msg.get("stamp", 0.0)))

        nxt = fetch_next()
        i = 0
        dev_outs: list = []
        stamps: list = []
        while nxt is not None:
            fut, t_end, stamp = nxt
            scan = fut.result()
            nxt = fetch_next()

            # reference odom_run.cpp imu_callback arrival emulation: make at
            # least one IMU sample visible before the offset latch fires
            if not sync.offset_set and cursor < len(imu):
                sync.push_imu(imu[cursor, 0], imu[cursor, 1:4], imu[cursor, 4:7])
                cursor += 1
            if sync.push_scan(stamp):
                self._on_loop_back(i)
            while (
                cursor < len(imu)
                and imu[cursor, 0] - sync.time_offset <= t_end
            ):
                sync.push_imu(imu[cursor, 0], imu[cursor, 1:4], imu[cursor, 4:7])
                cursor += 1

            t0 = time.perf_counter()
            segs, seg_cfg = self._segments(scan, i)
            # per-segment IMU windows: segments are equal-COUNT slices of
            # the time-sorted scan, so their time boundaries are
            # approximated by equal-time interpolation over
            # [stamp, t_end] (exact for uniform-rate scans; the reference
            # buckets IMU per sub-frame by accumulated segment time,
            # frame.cpp:53-99 — documented deviation, PARITY.md)
            scan_overflow = 0
            for s, seg in enumerate(segs):
                seg_t_end = (
                    t_end if s == len(segs) - 1
                    else stamp + (t_end - stamp) * (s + 1) / len(segs)
                )
                take = sync.take_until(seg_t_end, cap)
                scan_overflow += sync.last_overflow
                packet = lio.pack_imu_packet(
                    take[:, 0], take[:, 1:4], take[:, 4:7], cap
                )
                self.state, out = lio.step_donated(
                    self.state, seg, packet, seg_cfg
                )
            if sync_every and (i + 1) % sync_every == 0:
                jax.block_until_ready(out.pose)
            dt = time.perf_counter() - t0
            if i > 0:
                self.timer.record(dt)
            dev_outs.append(
                (out.pose, out.icp_iterations, out.num_correspondences,
                 out.residual_rms, out.sigma, out.map_voxels,
                 out.icp_converged, out.window_drops, out.imu_initialized,
                 out.used_imu, scan_overflow)
            )
            stamps.append(scan.t_begin)
            if (
                self.checkpoint_dir
                and self.checkpoint_every
                and (i + 1) % self.checkpoint_every == 0
            ):
                checkpoint_save(self.checkpoint_dir, self.state, i + 1)
            if progress:
                progress(i, out)
            self._backend_observe(i, out)
            self._maybe_rebuild(i)
            i += 1
        pool.shutdown()
        self._backend_observe(i, None, final=True)
        for i, (pose, iters, ncorr, rms, sigma, nvox, conv, wdrops, ini,
                used, ovf) in enumerate(dev_outs):
            self.poses.append(np.asarray(pose))
            self.stamps.append(float(stamps[i]))
            self.metrics.append(
                i,
                icp_iterations=iters,
                num_correspondences=ncorr,
                residual_rms=rms,
                sigma=sigma,
                map_voxels=nvox,
                icp_converged=conv,
                window_drops=wdrops,
                imu_initialized=ini,
                used_imu=used,
                imu_overflow=ovf,
            )
        return self
