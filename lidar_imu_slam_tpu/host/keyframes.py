"""Online keyframe backend: loop closure + pose-graph optimization behind
the odometry runner.

The reference promises loop closure and map optimization (reference
README.md:2, RAD workflow figure) but ships neither; round 1 built the
pose-graph machinery (`models/backend.py`) as an offline tool. This module
wires it ONLINE (VERDICT round 1, next-round #6):

  * keyframe selection by travelled distance / rotation against the last
    keyframe, fed from the runner in pose chunks (one host fetch per
    `BackendConfig.chunk` scans — each fetch syncs the device, so
    per-scan fetches would stall the pipeline),
  * periodic pose-graph optimization: odometry-chain edges from the RAW
    odometry poses + persisted ICP-verified loop-closure edges,
  * trajectory correction: every scan pose is re-anchored through its most
    recent keyframe's optimized pose.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import PipelineConfig
from ..models import backend as backend_mod


def _log():
    import logging

    return logging.getLogger(__name__)


class OnlineBackend:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        b = cfg.backend
        self.bcfg = b
        # raw odometry keyframes (never overwritten by optimization — the
        # odometry-chain edges must stay the original measurements)
        self.kf_poses: list[np.ndarray] = []
        self.kf_scan_idx: list[int] = []
        self.kf_clouds: list[np.ndarray] = []  # sensor-frame f32 (N, 3)
        self.kf_cloud_masks: list[np.ndarray] = []
        # persisted verified loop edges: (i, j, T_i_j, weight)
        self.loop_edges: list[tuple] = []
        self._checked_pairs: set[tuple] = set()
        self.optimized: Optional[np.ndarray] = None  # (K, 4, 4)
        self._kf_at_last_opt = 0
        self.num_optimizations = 0
        # capacity observability (round-2 VERDICT weak #5: the cap was a
        # silent `continue`)
        self.thin_events = 0
        self.dropped_keyframes = 0
        self.dropped_loop_edges = 0

    # -- keyframe ingestion -------------------------------------------------

    def observe_chunk(self, scan_indices, poses, clouds, masks) -> None:
        """poses: (C, 4, 4) numpy chunk; clouds/masks: per-scan WORLD-frame
        keypoint arrays (numpy or device; fetched only for selected
        keyframes)."""
        for k, i in enumerate(scan_indices):
            pose = np.asarray(poses[k], np.float64)
            if self.kf_poses:
                rel = np.linalg.inv(self.kf_poses[-1]) @ pose
                dist = float(np.linalg.norm(rel[:3, 3]))
                ang = float(
                    np.arccos(np.clip((np.trace(rel[:3, :3]) - 1.0) / 2.0, -1, 1))
                )
                if dist < self.bcfg.keyframe_dist and ang < self.bcfg.keyframe_rot:
                    continue
            if len(self.kf_poses) >= self.bcfg.max_keyframes:
                self._thin()
            if len(self.kf_poses) >= self.bcfg.max_keyframes:
                # thinning freed nothing (every old keyframe anchors a
                # verified loop edge) — drop the new keyframe, loudly
                self.dropped_keyframes += 1
                _log().warning(
                    "keyframe store full (%d) and fully loop-anchored; "
                    "dropping keyframe at scan %d (%d dropped so far)",
                    self.bcfg.max_keyframes, int(i), self.dropped_keyframes,
                )
                continue
            cloud = np.asarray(clouds[k], np.float32)
            mask = np.asarray(masks[k])
            # store in the SENSOR frame: loop verification registers
            # cloud_j against cloud_i under the relative-pose guess
            R, t = pose[:3, :3], pose[:3, 3]
            sensor = ((cloud.astype(np.float64) - t) @ R).astype(np.float32)
            self.kf_poses.append(pose)
            self.kf_scan_idx.append(int(i))
            self.kf_clouds.append(np.where(mask[:, None], sensor, 0.0))
            self.kf_cloud_masks.append(mask)
        if (
            len(self.kf_poses) - self._kf_at_last_opt >= self.bcfg.optimize_every
            and len(self.kf_poses) >= 3
        ):
            self.optimize()

    # -- capacity management --------------------------------------------------

    def _thin(self) -> None:
        """Halve the density of the OLDER half of the keyframe store:
        every second non-anchored old keyframe is dropped, loop-edge
        endpoints and the recent half are kept. Keyframe/loop-edge indices
        and the checked-pairs cache are remapped; the correction chain
        (`correct`) keeps working because `kf_scan_idx` stays sorted.

        Effect on accuracy: old sections keep a coarser (2x spacing) pose
        sampling — loop closures against them still fire (clouds are kept)
        and the odometry chain re-links across the dropped frames."""
        n = len(self.kf_poses)
        anchored = set()
        for (i, j, _, _) in self.loop_edges:
            anchored.add(i)
            anchored.add(j)
        half = n // 2
        keep = [
            k for k in range(n)
            if k >= half or k in anchored or k % 2 == 0
        ]
        if len(keep) == n:
            return
        remap = {old: new for new, old in enumerate(keep)}
        self.thin_events += 1
        self.dropped_keyframes += n - len(keep)
        _log().warning(
            "keyframe store reached %d: thinned oldest half %d -> %d "
            "keyframes (event %d)",
            n, half, sum(1 for k in keep if k < half), self.thin_events,
        )
        self.kf_poses = [self.kf_poses[k] for k in keep]
        self.kf_scan_idx = [self.kf_scan_idx[k] for k in keep]
        self.kf_clouds = [self.kf_clouds[k] for k in keep]
        self.kf_cloud_masks = [self.kf_cloud_masks[k] for k in keep]
        self.loop_edges = [
            (remap[i], remap[j], m, w) for (i, j, m, w) in self.loop_edges
        ]
        self._checked_pairs = {
            (remap[i], remap[j])
            for (i, j) in self._checked_pairs
            if i in remap and j in remap
        }
        if self.optimized is not None:
            self.optimized = self.optimized[[k for k in keep if k < len(self.optimized)]]
        self._kf_at_last_opt = sum(
            1 for k in keep if k < self._kf_at_last_opt
        )

    # -- optimization -------------------------------------------------------

    def _verify_fn(self):
        """Jitted keyframe-to-keyframe ICP (unjitted op-by-op dispatch
        would cost one launch per op per candidate)."""
        if getattr(self, "_verify_jit", None) is None:
            import dataclasses

            import jax

            from ..ops import icp as icp_ops
            from ..ops import voxel_map

            # keyframe clouds are ~4k points: a small dedicated table
            vcfg = dataclasses.replace(
                self.cfg.map, capacity=1 << 13, neighborhood=27
            )

            def verify(cloud_i, mask_i, cloud_j, mask_j, guess):
                m = voxel_map.create(vcfg)
                m = voxel_map.insert(m, cloud_i, mask_i, vcfg)
                return icp_ops.icp_registration(
                    m, cloud_j, mask_j, guess,
                    self.bcfg.verify_max_corresp,
                    self.bcfg.verify_max_corresp / 3.0,
                    vcfg, 30, 1e-5,
                )

            self._verify_jit = jax.jit(verify)
        return self._verify_jit

    def _verify_loops(self, g) -> None:
        """ICP-verify proximity candidates; persist accepted edges."""
        cand = backend_mod.find_loop_candidates(
            g, self.bcfg.loop_radius, self.bcfg.min_index_gap,
            self.bcfg.max_candidates,
        )
        mask = np.asarray(cand.mask)
        verify = self._verify_fn()
        for c in range(int(mask.sum())):
            i = int(cand.idx_i[c])
            j = int(cand.idx_j[c])
            if (i, j) in self._checked_pairs:
                continue
            self._checked_pairs.add((i, j))
            guess = np.linalg.inv(self.kf_poses[i]) @ self.kf_poses[j]
            res = verify(
                self.kf_clouds[i], self.kf_cloud_masks[i],
                self.kf_clouds[j], self.kf_cloud_masks[j], guess,
            )
            if (
                float(res.residual_rms) < self.bcfg.verify_max_residual
                and int(res.num_correspondences)
                >= self.bcfg.verify_min_correspondences
            ):
                self.loop_edges.append(
                    (i, j, np.asarray(res.pose), self.bcfg.loop_weight)
                )

    def optimize(self) -> None:
        b = self.bcfg
        # edge capacity: chain edges are mandatory; newest loops win
        loop_budget = b.max_edges - (len(self.kf_poses) - 1)
        if len(self.loop_edges) > loop_budget:
            drop = len(self.loop_edges) - loop_budget
            self.dropped_loop_edges += drop
            _log().warning(
                "edge store full: dropping %d oldest loop edges "
                "(%d total dropped; raise BackendConfig.max_edges)",
                drop, self.dropped_loop_edges,
            )
            self.loop_edges = self.loop_edges[drop:]
        g = backend_mod.from_chain(
            np.stack(self.kf_poses), b.max_keyframes, b.max_edges,
            weight=b.odom_weight,
        )
        # candidate search runs on current best estimates
        if self.optimized is not None and len(self.optimized) <= len(self.kf_poses):
            gp = np.asarray(g.poses).copy()
            gp[: len(self.optimized)] = self.optimized
            g = g._replace(poses=backend_mod.jnp.asarray(gp))
        self._verify_loops(g)
        for (i, j, meas, w) in self.loop_edges:
            g = backend_mod.add_edge(g, i, j, meas, w)
        if self.loop_edges:
            use_cg = b.solver == "cg" or (
                b.solver == "auto" and b.max_keyframes > 128
            )
            if use_cg:
                g = backend_mod.optimize_cg_jit(
                    g, iterations=b.lm_iterations,
                    cg_iterations=b.cg_iterations,
                )
            else:
                g = backend_mod.optimize_jit(g, iterations=b.lm_iterations)
            self.optimized = np.asarray(g.poses)[: len(self.kf_poses)]
        else:
            self.optimized = np.stack(self.kf_poses)
        self._kf_at_last_opt = len(self.kf_poses)
        self.num_optimizations += 1

    # -- trajectory correction ---------------------------------------------

    def correct(self, poses: np.ndarray) -> np.ndarray:
        """Re-anchor every scan pose through its most recent keyframe:
        T_i' = opt[k(i)] @ raw_kf[k(i)]^-1 @ T_i."""
        if self.optimized is None or not self.kf_poses:
            return poses
        out = np.array(poses, np.float64, copy=True)
        kf_idx = np.asarray(self.kf_scan_idx)
        for s in range(len(out)):
            k = int(np.searchsorted(kf_idx, s, side="right")) - 1
            if k < 0:
                continue
            delta = self.optimized[k] @ np.linalg.inv(self.kf_poses[k])
            out[s] = lie_np_orthonormalize(delta @ out[s])
        return out


def lie_np_orthonormalize(T: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    out = T.copy()
    out[:3, :3] = Rotation.from_matrix(T[:3, :3]).as_matrix()
    return out
