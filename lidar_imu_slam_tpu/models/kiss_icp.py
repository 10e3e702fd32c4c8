"""KISS-ICP-style LiDAR odometry as one jit-compiled functional step.

This is the path the reference actually wires end-to-end
(reference src/odom_run.cpp:154-185 -> src/sensors/lidar/icp.cpp:49-86):
constant-velocity deskew, double voxel downsample, IQR outlier rejection,
adaptive-threshold robust ICP against the voxel-hash local map, map update.

The reference spreads this over callback threads, mutex deques and a mutable
KissICP object; here the entire odometry is

    state' , out = register_frame(state, scan, cfg)

with `state` a pytree (fixed-capacity map + last two poses + threshold
stats) — jit/vmap/scan/shard_map-safe, checkpointable with orbax as-is.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops import deskew as deskew_ops
from ..ops import icp as icp_ops
from ..ops import lie, pose_chain, stats, voxel_map
from ..ops.preprocess import Scan


class KissState(NamedTuple):
    map: voxel_map.VoxelMap
    pose: jnp.ndarray  # (4,4) f64 — T_{n-1} (latest)
    pose_prev: jnp.ndarray  # (4,4) f64 — T_{n-2}
    first_pose: jnp.ndarray  # (4,4) f64 — poses.front() for has_moved
    num_poses: jnp.ndarray  # () i32
    threshold: icp_ops.ThresholdState


class FrameOutput(NamedTuple):
    pose: jnp.ndarray  # (4,4) f64 world pose of this scan
    keypoints: jnp.ndarray  # (S,3) f32 ICP source (world frame @ guess)
    keypoints_mask: jnp.ndarray  # (S,)
    deskewed: jnp.ndarray  # (M,3) f32 map-insert downsample (world frame)
    deskewed_mask: jnp.ndarray  # (M,)
    icp_iterations: jnp.ndarray  # () i32
    num_correspondences: jnp.ndarray  # () i32
    residual_rms: jnp.ndarray  # () f64
    sigma: jnp.ndarray  # () f64 adaptive threshold used
    map_voxels: jnp.ndarray  # () i32
    icp_converged: jnp.ndarray  # () bool
    window_drops: jnp.ndarray  # () i32 downsample-window invalidations


def init_state(cfg: PipelineConfig) -> KissState:
    # distinct buffers per field: a shared `eye` array would be the same
    # device buffer donated twice through register_frame_step
    return KissState(
        map=voxel_map.create(cfg.map),
        pose=jnp.eye(4, dtype=jnp.float64),
        pose_prev=jnp.eye(4, dtype=jnp.float64),
        first_pose=jnp.eye(4, dtype=jnp.float64),
        num_poses=jnp.int32(0),
        threshold=icp_ops.threshold_init(),
    )


def has_moved(state: KissState, min_motion_th: float) -> jnp.ndarray:
    """Reference icp.cpp:156-163: ||(first^-1 last).t|| > 5 * min_motion_th."""
    rel = lie.compose(lie.transform_inverse(state.first_pose), state.pose)
    motion = jnp.linalg.norm(rel[:3, 3])
    return (state.num_poses > 0) & (motion > 5.0 * min_motion_th)


def get_prediction_model(state: KissState) -> jnp.ndarray:
    """T_{n-2}^-1 T_{n-1} (reference icp.cpp:146-154)."""
    pred = lie.compose(lie.transform_inverse(state.pose_prev), state.pose)
    return jnp.where(state.num_poses < 2, jnp.eye(4, dtype=jnp.float64), pred)


class CoreOutput(NamedTuple):
    """Everything downstream bookkeeping needs from one registration."""

    new_map: voxel_map.VoxelMap
    threshold: icp_ops.ThresholdState
    pose: jnp.ndarray  # (4,4) f64 world pose (divergence-gated)
    keypoints: jnp.ndarray  # (S,3) f32 ICP source (world frame @ guess)
    keypoints_mask: jnp.ndarray
    map_points: jnp.ndarray  # (M,3) f32 corrected map-insert downsample
    map_points_mask: jnp.ndarray
    icp_iterations: jnp.ndarray
    num_correspondences: jnp.ndarray
    residual_rms: jnp.ndarray
    sigma: jnp.ndarray
    icp_converged: jnp.ndarray
    window_drops: jnp.ndarray  # () i32 — downsample-window invalidations
    # (fused map downsample + source downsample); nonzero means geometry
    # was silently lost to the packed-sort windows (weak #10)


def register_core(
    m: voxel_map.VoxelMap,
    threshold: icp_ops.ThresholdState,
    moved: jnp.ndarray,
    deskewed_xyz: jnp.ndarray,
    mask: jnp.ndarray,
    init_guess: jnp.ndarray,
    cfg: PipelineConfig,
    tau=None,
) -> CoreOutput:
    """Downsample -> adaptive-threshold robust ICP -> map update: the shared
    registration trunk of both the lidar-only step (`register_frame`) and
    the LIO step (`models.lio.step`), = reference icp.cpp:58-86.

    Takes already-deskewed sensor-frame points plus the world initial guess
    (constant-velocity for lidar-only, the EKF pose for LIO — the pipeline
    coupling the reference designed but never wired)."""
    # world transform at the guess (f32 ELEMENTWISE — an f32 matmul may run
    # at reduced precision and quantize every point, see lie.rotate_points)
    # + fused grouped downsample (map insert @ 0.5*vox; icp.cpp:126-135)
    Rg = init_guess[:3, :3].astype(jnp.float32)
    tg = init_guess[:3, 3].astype(jnp.float32)
    world = lie.rotate_points(Rg, deskewed_xyz) + tg
    # unsorted scans (sort_by_time=False) carry their time into the sort
    # key so the within-cell winner is still the earliest point —
    # reference first-wins semantics without the preprocess-side sort
    g = voxel_map.fused_downsample(
        world, mask, cfg.map.voxel_size, cfg.icp.max_map_points,
        tau=None if cfg.lidar.sort_by_time else tau,
    )

    # ICP source: second downsample @ 1.5*vox + IQR range-outlier mask
    # (reference icp.cpp:88-135; ranges measured from the sensor origin)
    source, source_mask, _, src_drops = voxel_map.first_point_per_voxel(
        g.points, g.mask, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points
    )
    d_sq = jnp.sum((source - tg[None, :]) ** 2, axis=-1)
    source_mask = stats.iqr_inlier_mask(d_sq.astype(jnp.float64), source_mask)

    # adaptive sigma (accumulates previous frame's model deviation)
    thr_state, sigma = icp_ops.compute_threshold(
        threshold,
        moved,
        cfg.icp.initial_threshold,
        cfg.icp.min_motion_th,
        cfg.map.max_range,
    )

    # robust GN-ICP (max_corr = 3 sigma, kernel = sigma/3; icp.cpp:74-76) on
    # world-frame source from identity. The config selects the backend
    # (fused f32 GN loop vs f64 XLA loops) and schedule (while loop vs
    # fixed unroll for batched execution).
    result = icp_ops.registration_dispatch(
        m, source, source_mask, jnp.eye(4, dtype=jnp.float64),
        sigma, cfg.map, cfg.icp,
    )
    pose_icp = lie.compose(result.pose, init_guess)
    # scan-level divergence gate: a wild registration would poison the map
    # and compound through the motion prediction
    model_dev = lie.compose(lie.transform_inverse(init_guess), pose_icp)
    diverged = jnp.linalg.norm(model_dev[:3, 3]) > cfg.icp.max_model_deviation
    new_pose = lie.orthonormalize(jnp.where(diverged, init_guess, pose_icp))
    model_dev = jnp.where(diverged, jnp.eye(4, dtype=jnp.float64), model_dev)

    # model deviation for the next frame's threshold (icp.cpp:78-79)
    thr_state = icp_ops.update_model_deviation(thr_state, model_dev)

    # map update with the grouped downsample, correcting world points by
    # the ICP delta only (icp.cpp:81); no re-sort needed
    delta = lie.compose(new_pose, lie.transform_inverse(init_guess))
    Rd = delta[:3, :3].astype(jnp.float32)
    td = delta[:3, 3].astype(jnp.float32)
    g_corr = g._replace(points=lie.rotate_points(Rd, g.points) + td)
    # block keys come from the PRE-correction grouping voxels: they are
    # unique per group by construction, whereas keys recomputed from the
    # corrected points can collide when the ICP delta moves two adjacent
    # groups into one voxel — colliding groups would scatter into the same
    # block rows and silently overwrite each other. The key is then at most
    # one voxel off (delta is small post-convergence); the 27-neighborhood
    # NN still finds the points. Documented deviation (PARITY.md).
    pre_keys = voxel_map.pack_key(
        voxel_map.voxel_of(g.points, cfg.map.voxel_size)
    )
    new_map = voxel_map.insert_grouped(m, g_corr, cfg.map, keys=pre_keys)
    if cfg.map.auto_evict:
        new_map = voxel_map.evict_far(new_map, new_pose[:3, 3], cfg.map)

    # device-side slab compaction: the bump allocator reclaims evicted
    # (tombstoned) slots only through `rebuild`; without this, a map under
    # capacity pressure silently stops accepting new voxels between the
    # host's periodic rebuilds and odometry diverges (the host does not
    # poll the cursor per scan: that would sync the device every scan).
    # lax.cond executes one branch at runtime, so the compaction cost
    # (one cumsum + slab scatter) is paid only when the cursor nears
    # capacity AND tombstones are worth reclaiming. Gated off for vmapped
    # streams (batch_config): under a batched predicate cond lowers to
    # select and BOTH branches would run every scan.
    if cfg.map.auto_rebuild:
        cap = cfg.map.capacity
        need = (new_map.next_slot > cap - cap // 8) & (
            new_map.tombstones > cap // 16
        )
        new_map = jax.lax.cond(
            need, lambda mm: voxel_map.rebuild(mm, cfg.map), lambda mm: mm,
            new_map,
        )

    return CoreOutput(
        new_map=new_map,
        threshold=thr_state,
        pose=new_pose,
        keypoints=source,
        keypoints_mask=source_mask,
        map_points=g_corr.points,
        map_points_mask=g.mask,
        icp_iterations=result.iterations,
        num_correspondences=result.num_correspondences,
        residual_rms=result.residual_rms,
        sigma=sigma,
        icp_converged=result.converged,
        window_drops=g.window_drops + src_drops,
    )


def pose_pre_row(state: KissState, cfg: PipelineConfig):
    """Run the pre-ICP bookkeeping chain on the pose state: ONE
    float-float split of every f64 scalar it consumes. Returns the (33,)
    f32 row (CV guess, adaptive sigma, moved flag, threshold accumulators,
    deskew twist pieces — ops/pose_chain.py docstring)."""
    thr = state.threshold
    vec = jnp.concatenate([
        state.pose.reshape(16),
        state.pose_prev.reshape(16),
        state.first_pose.reshape(16),
        thr.model_error_sq.reshape(1),
    ])
    hi = vec.astype(jnp.float32)
    lo = (vec - hi.astype(jnp.float64)).astype(jnp.float32)
    md = thr.model_deviation.reshape(16).astype(jnp.float32)
    ints = jnp.stack([state.num_poses, thr.num_samples])
    return pose_chain.pose_pre(
        hi, lo, md, ints,
        min_motion_th=cfg.icp.min_motion_th,
        initial_threshold=cfg.icp.initial_threshold,
        max_range=cfg.map.max_range,
        deskew_on=cfg.icp.deskew,
    )


class FastCoreOutput(NamedTuple):
    """Raw f32/ff results of one fast-trunk registration (recombine to f64
    only where downstream consumers need it)."""

    new_map: voxel_map.VoxelMap
    prow: jnp.ndarray  # (44,) pose_post row: new pose, delta, model dev
    source: jnp.ndarray
    source_mask: jnp.ndarray
    map_points: jnp.ndarray  # corrected insert downsample (world)
    map_points_mask: jnp.ndarray
    sigma: jnp.ndarray  # () f32
    iterations: jnp.ndarray
    num_correspondences: jnp.ndarray
    residual_rms: jnp.ndarray  # () f32
    converged: jnp.ndarray
    window_drops: jnp.ndarray


def _fast_trunk(
    m: voxel_map.VoxelMap,
    deskewed_xyz: jnp.ndarray,
    mask: jnp.ndarray,
    tau,
    guess_R9: jnp.ndarray,  # (9,) f32
    g_th: jnp.ndarray,  # (3,) f32 guess translation hi
    g_tl: jnp.ndarray,  # (3,) f32 guess translation lo
    sigma: jnp.ndarray,  # () f32 adaptive threshold
    cfg: PipelineConfig,
) -> FastCoreOutput:
    """The fast registration trunk shared by the lidar-only fast path and
    the LIO fast path: world transform at the guess, fused grouped
    downsample, IQR source mask, float-float-carrier fused ICP,
    pose_post bookkeeping chain, map insert/evict (+ conditional
    compaction). Mirrors `register_core` (reference icp.cpp:58-86) with
    the documented fast-path precision deviations (PARITY.md #24)."""
    # world transform at the guess + fused grouped downsample (f32 pair
    # instead of f64 pose)
    x, y, z = deskewed_xyz[:, 0], deskewed_xyz[:, 1], deskewed_xyz[:, 2]
    tg = g_th + g_tl
    wx = guess_R9[0] * x + guess_R9[1] * y + guess_R9[2] * z + tg[0]
    wy = guess_R9[3] * x + guess_R9[4] * y + guess_R9[5] * z + tg[1]
    wz = guess_R9[6] * x + guess_R9[7] * y + guess_R9[8] * z + tg[2]
    world = jnp.stack([wx, wy, wz], axis=-1)
    g = voxel_map.fused_downsample(
        world, mask, cfg.map.voxel_size, cfg.icp.max_map_points,
        tau=None if cfg.lidar.sort_by_time else tau,
    )
    source, source_mask, _, src_drops = voxel_map.first_point_per_voxel(
        g.points, g.mask, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points
    )
    d_sq = jnp.sum((source - tg[None, :]) ** 2, axis=-1)
    source_mask = stats.iqr_inlier_mask(d_sq.astype(jnp.float64), source_mask)

    # ICP on the WORLD-frame source from an identity carrier — the result
    # is the correction only; pose_post composes corr @ guess (classic
    # path: registration_dispatch with identity + lie.compose)
    eye9 = jnp.asarray([1, 0, 0, 0, 1, 0, 0, 0, 1], jnp.float32)
    zero3 = jnp.zeros(3, jnp.float32)
    R9f, thf, tlf, iters, n_corr, rms, conv = icp_ops.icp_registration_fused_pair(
        m=m, points=source, mask=source_mask,
        guess_R9=eye9, guess_th=zero3, guess_tl=zero3,
        max_corresp_dist=3.0 * sigma, kernel_th=sigma / 3.0,
        map_cfg=cfg.map, max_iterations=cfg.icp.max_iterations,
        estimation_threshold=cfg.icp.estimation_threshold,
        min_correspondences=cfg.icp.min_correspondences,
        max_step_norm=cfg.icp.max_step_norm, n_inner=cfg.icp.fused_inner,
    )

    prow = pose_chain.pose_post(
        jnp.concatenate([R9f, thf, tlf, guess_R9, g_th, g_tl]),
        max_model_deviation=cfg.icp.max_model_deviation,
    )

    # map update with the correction delta only (reference icp.cpp:81)
    delta_R = prow[16:25].reshape(3, 3)
    g_corr = g._replace(
        points=lie.rotate_points(delta_R, g.points) + prow[25:28]
    )
    pre_keys = voxel_map.pack_key(
        voxel_map.voxel_of(g.points, cfg.map.voxel_size)
    )
    new_map = voxel_map.insert_grouped(m, g_corr, cfg.map, keys=pre_keys)
    if cfg.map.auto_evict:
        new_map = voxel_map.evict_far(new_map, prow[9:12], cfg.map)
    if cfg.map.auto_rebuild:
        cap = cfg.map.capacity
        need = (new_map.next_slot > cap - cap // 8) & (
            new_map.tombstones > cap // 16
        )
        new_map = jax.lax.cond(
            need, lambda mm: voxel_map.rebuild(mm, cfg.map), lambda mm: mm,
            new_map,
        )
    return FastCoreOutput(
        new_map=new_map,
        prow=prow,
        source=source,
        source_mask=source_mask,
        map_points=g_corr.points,
        map_points_mask=g.mask,
        sigma=sigma,
        iterations=iters,
        num_correspondences=n_corr,
        residual_rms=rms,
        converged=conv,
        window_drops=g.window_drops + src_drops,
    )


def fast_pose_from_prow(prow: jnp.ndarray) -> jnp.ndarray:
    """Recombine pose_post's float-float pose row into the f64 (4,4)."""
    return lie.make_transform(
        prow[0:9].reshape(3, 3).astype(jnp.float64),
        prow[9:12].astype(jnp.float64) + prow[12:15].astype(jnp.float64),
    )


def fast_threshold_state(row, prow) -> icp_ops.ThresholdState:
    """Recombine the threshold accumulators from the pre/post rows."""
    return icp_ops.ThresholdState(
        row[17].astype(jnp.float64) + row[32].astype(jnp.float64),
        row[18].astype(jnp.int32),
        prow[28:44].astype(jnp.float64).reshape(4, 4),
    )


def _register_frame_fast(state: KissState, scan: Scan, cfg: PipelineConfig):
    """`register_frame` with the per-scan pose bookkeeping in two f32 +
    float-float chains (ops/pose_chain.py) and the ICP carrier in f32 +
    float-float — the fused-backend fast path.

    The f64 state crosses into f32/float-float ONCE per scan (one packed
    split, one packed recombine); everything between is the two scalar
    chains plus f32 vector work. Same math as `register_frame` up to documented
    precision deviations (PARITY.md): f32 rotations (per-scan numeric
    noise ~1e-7 rad, 3 orders below ICP noise), float-float translations
    (~2^-48), Newton orthonormalization instead of the quaternion
    round-trip."""
    row = pose_pre_row(state, cfg)

    # vector deskew driven by pose_pre's twist scalars (identity when the
    # chain gated them to zero — no lax.cond)
    deskewed_xyz = deskew_ops.deskew_from_scalars(scan.xyz, scan.tau, row[19:32])

    core = _fast_trunk(
        state.map, deskewed_xyz, scan.mask, scan.tau,
        row[0:9], row[9:12], row[12:15], row[15], cfg,
    )

    # ONE recombine back to the f64 state/output dtypes
    new_pose = fast_pose_from_prow(core.prow)
    thr_state = fast_threshold_state(row, core.prow)

    new_state = KissState(
        map=core.new_map,
        pose=new_pose,
        pose_prev=jnp.where(state.num_poses == 0, new_pose, state.pose),
        first_pose=jnp.where(state.num_poses == 0, new_pose, state.first_pose),
        num_poses=state.num_poses + 1,
        threshold=thr_state,
    )
    out = FrameOutput(
        pose=new_pose,
        keypoints=core.source,
        keypoints_mask=core.source_mask,
        deskewed=core.map_points,
        deskewed_mask=core.map_points_mask,
        icp_iterations=core.iterations,
        num_correspondences=core.num_correspondences,
        residual_rms=core.residual_rms.astype(jnp.float64),
        sigma=core.sigma.astype(jnp.float64),
        map_voxels=voxel_map.num_voxels(core.new_map),
        icp_converged=core.converged,
        window_drops=core.window_drops,
    )
    return new_state, out


def register_frame(state: KissState, scan: Scan, cfg: PipelineConfig):
    """One odometry step (reference icp.cpp:49-86). Returns (state', FrameOutput).

    Device-first restructure of the reference flow (each deviation documented):
      * the scan is transformed to WORLD frame at the motion-model guess
        BEFORE downsampling, so one fused sort yields both the 0.5*voxel
        map downsample AND its grouping by map voxel — the map insert then
        needs no second sort. (The reference downsamples in sensor frame,
        icp.cpp:126-135; grid alignment differs by the guess pose — same
        density, documented in PARITY.md.)
      * ICP runs on the world-frame source with an identity initial
        transform: T_final = T_icp @ init_guess, algebraically identical to
        the reference's sensor-frame loop.
      * map insert applies only the ICP correction delta to the already
        world-frame downsample (the reference re-transforms from sensor
        frame, voxel_hash_map.cpp:132-144 — same points up to f32 rounding).
    """
    if cfg.icp.gn_backend == "fused" and cfg.icp.batch_unroll_outer == 0:
        # unbatched fused path: pose bookkeeping in two f32 chains,
        # float-float ICP carrier. Batched configs (batch_unroll_outer > 0,
        # set by parallel.streams.batch_config) stay on the classic path
        # below, whose f64 chain vectorizes across streams.
        return _register_frame_fast(state, scan, cfg)
    # 1. constant-velocity deskew, gated on config (static — lax.cond would
    #    run the per-point exp map under vmap even when disabled) and on
    #    >= 3 poses (reference icp.cpp:36-47)
    if cfg.icp.deskew:
        deskewed_xyz = jax.lax.cond(
            state.num_poses > 2,
            lambda: deskew_ops.constant_velocity_deskew_fast(
                scan.xyz, scan.tau, state.pose_prev, state.pose
            ),
            lambda: scan.xyz,
        )
    else:
        deskewed_xyz = scan.xyz

    # 2. constant-velocity prediction as initial guess
    last_pose = jnp.where(
        state.num_poses == 0, jnp.eye(4, dtype=jnp.float64), state.pose
    )
    init_guess = lie.compose(last_pose, get_prediction_model(state))

    # 3-8. shared registration trunk (downsample -> adaptive-threshold ICP
    #      -> divergence gate -> map insert/evict)
    moved = has_moved(state, cfg.icp.min_motion_th)
    core = register_core(
        state.map, state.threshold, moved, deskewed_xyz, scan.mask,
        init_guess, cfg, tau=scan.tau,
    )

    # 9. pose bookkeeping (icp.cpp:82)
    new_state = KissState(
        map=core.new_map,
        pose=core.pose,
        pose_prev=jnp.where(state.num_poses == 0, core.pose, state.pose),
        first_pose=jnp.where(state.num_poses == 0, core.pose, state.first_pose),
        num_poses=state.num_poses + 1,
        threshold=core.threshold,
    )
    out = FrameOutput(
        pose=core.pose,
        keypoints=core.keypoints,
        keypoints_mask=core.keypoints_mask,
        deskewed=core.map_points,
        deskewed_mask=core.map_points_mask,
        icp_iterations=core.icp_iterations,
        num_correspondences=core.num_correspondences,
        residual_rms=core.residual_rms,
        sigma=core.sigma,
        map_voxels=voxel_map.num_voxels(core.new_map),
        icp_converged=core.icp_converged,
        window_drops=core.window_drops,
    )
    return new_state, out


@partial(jax.jit, static_argnames=("cfg",))
def register_frame_jit(state: KissState, scan: Scan, cfg: PipelineConfig):
    return register_frame(state, scan, cfg)


# Donating variant for sequential drivers (runner/bench): the state's map
# slabs are ~160 MB at KITTI scale and the insert/evict updates copy them
# in full without input-output aliasing. Callers MUST NOT reuse the passed
# state after the call.
register_frame_step = jax.jit(
    register_frame, static_argnames=("cfg",), donate_argnums=(0,)
)


def current_velocity(state: KissState, scan_duration: float, min_motion_th: float):
    """(linear, angular) velocity from the last two poses (reference icp.cpp:165-172)."""
    twist = lie.delta_pose(state.pose_prev, state.pose) / scan_duration
    moved = has_moved(state, min_motion_th)
    zeros = jnp.zeros(3, dtype=jnp.float64)
    return (
        jnp.where(moved, twist[:3], zeros),
        jnp.where(moved, twist[3:], zeros),
    )
