"""LiDAR-inertial odometry: the reference's *intended* three-stage pipeline,
actually wired.

The reference implements (1) IMU static initialization, (2) IMU forward
propagation + motion compensation, and (3) an error-state EKF with pose
trail — but its shipped main loop never calls them (`kalman_filter_process`
has no caller: reference src/odom_run.cpp:135-152 vs :154-185, and
`EKF::predict` has no caller at all). This module composes them the way the
RAD design describes (LiDAR-inertial initialization -> KISS-ICP matching ->
HybVIO-style EKF odometry), adding the LiDAR pose measurement update the
reference never implemented.

Per-scan step:
  1. while IMU static init is running: ICP-only odometry with
     constant-velocity deskew (the reference's fallback, odom_run.cpp:148-150)
  2. after init: per-sample EKF predict over the scan's IMU packet,
     IMU-trajectory motion compensation of the scan, robust GN-ICP against
     the voxel map seeded by the EKF pose, EKF pose update, ZUPT +
     pose-trail augmentation, map update.

Everything is one jit-compiled functional step over a single state pytree.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops import imu as imu_ops
from ..ops import lie, voxel_map
from ..ops.preprocess import Scan
from . import ekf as ekf_mod
from . import kiss_icp


VEL_RING = 8  # CV-phase finite-difference velocity history (accel seed)


class LioState(NamedTuple):
    odo: kiss_icp.KissState  # map + pose history + adaptive threshold
    ekf: ekf_mod.EkfState
    imu_init: imu_ops.ImuInitState
    last_imu: jnp.ndarray  # (7,) f64: [t, gyro(3), acc(3)] of previous packet tail
    scan_count: jnp.ndarray  # () i32
    vel_ring: jnp.ndarray  # (VEL_RING,3) f64 recent odometry velocities
    vel_ring_n: jnp.ndarray  # () i32 valid entries (newest at row -1)
    init_v0: jnp.ndarray  # (3,) f64 odometry velocity at init-window start
    init_t0: jnp.ndarray  # () f64 its timestamp; -1 = not latched yet


class LioOutput(NamedTuple):
    pose: jnp.ndarray  # (4,4) f64 world-from-lidar at scan end
    ekf_pose: jnp.ndarray  # (4,4) f64 world-from-imu
    velocity: jnp.ndarray  # (3,) f64
    keypoints: jnp.ndarray  # (S,3) f32 ICP source (world frame @ guess)
    keypoints_mask: jnp.ndarray
    deskewed: jnp.ndarray  # (M,3) f32 map-insert downsample
    deskewed_mask: jnp.ndarray
    icp_iterations: jnp.ndarray
    num_correspondences: jnp.ndarray
    residual_rms: jnp.ndarray
    sigma: jnp.ndarray
    map_voxels: jnp.ndarray  # () i32
    icp_converged: jnp.ndarray  # () bool
    window_drops: jnp.ndarray  # () i32 downsample-window invalidations
    imu_initialized: jnp.ndarray  # () bool
    used_imu: jnp.ndarray  # () bool — IMU deskew active this scan


def init_state(cfg: PipelineConfig) -> LioState:
    return LioState(
        odo=kiss_icp.init_state(cfg),
        ekf=ekf_mod.init(cfg.ekf),
        imu_init=imu_ops.init_state(),
        last_imu=jnp.zeros((7,), jnp.float64),
        scan_count=jnp.int32(0),
        vel_ring=jnp.zeros((VEL_RING, 3), jnp.float64),
        vel_ring_n=jnp.int32(0),
        init_v0=jnp.zeros((3,), jnp.float64),
        init_t0=jnp.float64(-1.0),
    )


def _ring_accel(ring, n, dt):
    """Least-squares world-acceleration from the velocity ring.

    The ring holds the last `n` (<= VEL_RING) per-scan finite-difference
    velocities, newest at row -1, assumed dt-spaced. The LS slope over m
    samples has variance 12 sigma_v^2 / (m (m^2-1) dt^2) — at m=8 that is
    ~18x below the two-sample second difference (sigma ~0.1 vs ~2 m/s^2
    from mm-level ICP pose noise at dt=0.1), while a genuine launch ramp
    (5-10 m/s^2) still comes through at full scale. Returns zeros until 3
    samples exist (the rest-assumption seed is better-conditioned than a
    2-point slope)."""
    m = jnp.minimum(n, VEL_RING)
    idx = jnp.arange(VEL_RING, dtype=jnp.float64)
    valid = idx >= (VEL_RING - m)
    w = valid.astype(jnp.float64)
    t = idx * dt
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    tbar = jnp.sum(w * t) / wsum
    vbar = jnp.sum(w[:, None] * ring, axis=0) / wsum
    ct = w * (t - tbar)
    denom = jnp.sum(ct * t)
    slope = jnp.sum(ct[:, None] * ring, axis=0) / jnp.where(
        denom > 0, denom, 1.0
    )
    return jnp.where((m >= 3) & (denom > 0), slope, jnp.zeros(3, jnp.float64))


def _with_prev_sample(packet: ekf_mod.ImuPacket, last_imu) -> ekf_mod.ImuPacket:
    """Prepend the previous packet's tail sample (reference ekf.cpp:295)."""
    has_prev = last_imu[0] > 0
    return ekf_mod.ImuPacket(
        time=jnp.concatenate([last_imu[0][None], packet.time]),
        gyro=jnp.concatenate([last_imu[1:4][None], packet.gyro]),
        acc=jnp.concatenate([last_imu[4:7][None], packet.acc]),
        mask=jnp.concatenate([has_prev[None], packet.mask]),
    )


def step(
    state: LioState, scan: Scan, packet: ekf_mod.ImuPacket, cfg: PipelineConfig
):
    """One LIO step. Returns (state', LioOutput).

    With the fused backend (unbatched), registration runs through the
    same fast trunk as the lidar-only step (`kiss_icp._fast_trunk`: f32
    pose chains + float-float ICP carrier) instead of the classic f64
    `registration_dispatch` while loop — the EKF guess feeds the trunk as
    one f64->float-float split, and only the EKF algebra itself stays f64.
    """
    fast = cfg.icp.gn_backend == "fused" and cfg.icp.batch_unroll_outer == 0
    full = _with_prev_sample(packet, state.last_imu)

    # --- IMU static initialization phase --------------------------------
    acc_remapped = imu_ops.remap_axes(full.acc, cfg.imu.coordinate)
    imu_init_next = imu_ops.accumulate(
        state.imu_init, full.gyro, acc_remapped, full.mask, cfg.imu
    )
    just_done = imu_init_next.done & ~state.imu_init.done
    ekf_state = state.ekf  # seeding happens after registration (see below)
    use_imu = state.imu_init.done  # initialized before this scan

    # --- branch A: IMU-driven deskew + EKF ------------------------------
    def imu_branch(ekf_state):
        p_il = ekf_state.m[ekf_mod.PIL:ekf_mod.PIL + 3]
        R_il = lie.quat_to_rot(ekf_state.m[ekf_mod.RIL:ekf_mod.RIL + 4])
        ekf_state = ekf_mod.predict_dispatch(ekf_state, full, p_il, R_il, cfg.ekf)
        # extrapolate the nominal state to SCAN END (zero-order hold on the
        # last sample — the reference's frame-end extrapolation,
        # ekf.cpp:393-410, applied to the filter state): the last IMU
        # sample lands up to one IMU period BEFORE scan end, but the ICP
        # guess and the lidar pose measurement are both at scan end.
        # Without this the update injects the uncovered ~10 ms of motion
        # as a forward position residual every scan and the filter
        # explains it by inflating velocity (measured: |v| climbing
        # ~1 m/s per scan above truth on the 8 m/s bench).
        nv = jnp.sum(full.mask, dtype=jnp.int32)
        li = jnp.maximum(nv - 1, 0)
        # mean-only: the reference's frame-end extrapolation never touches
        # the covariance (ekf.cpp:393-410), and the hold spans at most one
        # IMU period
        ekf_state = ekf_mod.predict_mean(
            ekf_state, scan.t_end, full.gyro[li], full.acc[li],
            ekf_state.m[ekf_mod.GRAV_I:ekf_mod.GRAV_I + 3],
            p_il, R_il, cfg.ekf,
        )
        mean_acc_norm = jnp.linalg.norm(state.imu_init.mean_acc)
        ekf_state, deskewed, _ = ekf_mod.motion_compensation_with_imu(
            ekf_state, full, scan.xyz, scan.rel_t, scan.mask,
            mean_acc_norm, scan.t_begin, cfg.ekf,
        )
        T_il = lie.make_transform(
            lie.quat_to_rot(ekf_state.m[ekf_mod.RIL:ekf_mod.RIL + 4]),
            ekf_state.m[ekf_mod.PIL:ekf_mod.PIL + 3],
        )
        guess = lie.compose(ekf_mod.pose_matrix(ekf_state), T_il)
        return ekf_state, deskewed, guess

    # pre-ICP bookkeeping row (fast path): CV guess + adaptive sigma +
    # deskew twist in one f32 chain
    row = kiss_icp.pose_pre_row(state.odo, cfg) if fast else None

    # --- branch B: constant-velocity fallback ---------------------------
    def cv_branch(ekf_state):
        from ..ops import deskew as deskew_ops

        if fast:
            # chain-gated twist: identity when deskew off or < 3 poses
            deskewed = deskew_ops.deskew_from_scalars(
                scan.xyz, scan.tau, row[19:32]
            )
            guess = lie.make_transform(
                row[0:9].reshape(3, 3).astype(jnp.float64),
                row[9:12].astype(jnp.float64) + row[12:15].astype(jnp.float64),
            )
            return ekf_state, deskewed, guess
        if cfg.icp.deskew:
            deskewed = jax.lax.cond(
                state.odo.num_poses > 2,
                lambda: deskew_ops.constant_velocity_deskew_fast(
                    scan.xyz, scan.tau, state.odo.pose_prev, state.odo.pose
                ),
                lambda: scan.xyz,
            )
        else:
            deskewed = scan.xyz
        last_pose = jnp.where(
            state.odo.num_poses == 0, jnp.eye(4, dtype=jnp.float64), state.odo.pose
        )
        guess = lie.compose(last_pose, kiss_icp.get_prediction_model(state.odo))
        return ekf_state, deskewed, guess

    ekf_state, deskewed_xyz, init_guess = jax.lax.cond(
        use_imu, imu_branch, cv_branch, ekf_state
    )

    # --- registration: shared trunk with the lidar-only step -------------
    #     (fused grouped downsample -> adaptive-threshold ICP -> divergence
    #     gate -> map insert/evict), seeded by the EKF pose when the IMU is
    #     initialized
    if fast:
        # ONE f64 -> float-float split of the guess (EKF pose or the
        # recombined CV guess) feeds the fast trunk
        gv = init_guess.reshape(16)
        gh = gv.astype(jnp.float32)
        gl = (gv - gh.astype(jnp.float64)).astype(jnp.float32)
        rot_idx = jnp.asarray([0, 1, 2, 4, 5, 6, 8, 9, 10])
        t_idx = jnp.asarray([3, 7, 11])
        fcore = kiss_icp._fast_trunk(
            state.odo.map, deskewed_xyz, scan.mask, scan.tau,
            gh[rot_idx], gh[t_idx], gl[t_idx], row[15], cfg,
        )
        core = kiss_icp.CoreOutput(
            new_map=fcore.new_map,
            threshold=kiss_icp.fast_threshold_state(row, fcore.prow),
            pose=kiss_icp.fast_pose_from_prow(fcore.prow),
            keypoints=fcore.source,
            keypoints_mask=fcore.source_mask,
            map_points=fcore.map_points,
            map_points_mask=fcore.map_points_mask,
            icp_iterations=fcore.iterations,
            num_correspondences=fcore.num_correspondences,
            residual_rms=fcore.residual_rms.astype(jnp.float64),
            sigma=fcore.sigma.astype(jnp.float64),
            icp_converged=fcore.converged,
            window_drops=fcore.window_drops,
        )
    else:
        moved = kiss_icp.has_moved(state.odo, cfg.icp.min_motion_th)
        core = kiss_icp.register_core(
            state.odo.map, state.odo.threshold, moved, deskewed_xyz, scan.mask,
            init_guess, cfg,
        )

    # --- EKF measurement update + trail maintenance ----------------------
    def ekf_update(e):
        T_il = lie.make_transform(
            lie.quat_to_rot(e.m[ekf_mod.RIL:ekf_mod.RIL + 4]),
            e.m[ekf_mod.PIL:ekf_mod.PIL + 3],
        )
        T_wi = lie.compose(core.pose, lie.transform_inverse(T_il))
        e = ekf_mod.lidar_pose_update(e, T_wi, cfg.ekf.lidar_pos_noise, cfg.ekf.lidar_ori_noise, cfg.ekf)
        return ekf_mod.update_and_propagate(e, cfg.ekf)

    ekf_state = jax.lax.cond(use_imu, ekf_update, lambda e: e, ekf_state)

    # CV-phase velocity ring: per-scan finite-difference world velocity of
    # the odometry, newest last. Feeds the LS acceleration estimate of the
    # odometry seed below (a raw 3-pose second difference amplifies ICP
    # pose noise by 1/dt^2 — measured ~2.3 m/s^2 of phantom acceleration
    # seeding gravity 13 deg off vertical on the constant-velocity bench,
    # costing the filter ~25 scans of 10+ ICP iterations to unwind).
    # Frozen once the EKF runs (the seed has been consumed).
    dt_scan = jnp.maximum(scan.t_end - scan.t_begin, 1e-3)
    v_fd = (core.pose[:3, 3] - state.odo.pose[:3, 3]) / dt_scan
    track = (state.odo.num_poses > 0) & ~use_imu
    vel_ring = jnp.where(
        track,
        jnp.concatenate([state.vel_ring[1:], v_fd[None, :]]),
        state.vel_ring,
    )
    vel_ring_n = jnp.where(
        track,
        jnp.minimum(state.vel_ring_n + 1, VEL_RING),
        state.vel_ring_n,
    )
    # latch the first available odometry velocity as the init-window start
    # (the static-init accumulator starts consuming samples at scan 0; the
    # first finite-difference velocity exists one scan later)
    latch = track & (state.init_t0 < 0)
    init_v0 = jnp.where(latch, v_fd, state.init_v0)
    init_t0 = jnp.where(latch, scan.t_end, state.init_t0)

    # static init completed THIS scan: seed the EKF nominal state from the
    # running odometry (pose, finite-difference velocity, gravity rotated
    # into the odometry world frame). Seeding at identity/zero-velocity
    # when init completes in motion teleports the next scan's guess
    # (ekf_mod.initialize_from_odometry docstring; PARITY.md #26).
    def seed(e):
        T_il = lie.make_transform(
            lie.quat_to_rot(e.m[ekf_mod.RIL:ekf_mod.RIL + 4]),
            e.m[ekf_mod.PIL:ekf_mod.PIL + 3],
        )
        # frame-convention handoff: with deskew on, the CV odometry's
        # poses anchor at MID-scan (the tau-0.5 deskew frame), while the
        # EKF nominal state and every lidar pose measurement after it are
        # at SCAN END — seeding the raw mid-scan pose leaves a
        # 0.5*dt*|v| forward position residual (40 cm at 8 m/s) for the
        # first update, which the loose velocity prior converts into a
        # ~2 m/s velocity overshoot and a ~30-scan underdamped transient
        # (measured; ICP burned 10-12 iterations/scan throughout).
        anchor_pose = core.pose
        if cfg.icp.deskew:
            anchor_pose = anchor_pose.at[:3, 3].add(0.5 * dt_scan * v_fd)
        T_wi = lie.compose(anchor_pose, lie.transform_inverse(T_il))
        vel = jnp.where(
            state.odo.num_poses > 0, v_fd, jnp.zeros(3, jnp.float64)
        )
        # world acceleration averaged over the init window: `mean_acc` is
        # the MEAN specific force over the whole static-init window, so
        # the correction g = a_w - R_wb f_b needs the WINDOW-MEAN world
        # acceleration (v_end - v_start) / T — an end-of-window estimate
        # (second difference or ring slope) reads ~0 whenever the window
        # covered a ramp that has since flattened, leaving the ramp's
        # mean (~4 m/s^2 on the 2 s 0->8 m/s bench lead-in) in the
        # gravity seed (measured: 13 deg off vertical, ~25 scans of
        # 10+ ICP iterations while the filter unwound it). Falls back to
        # the ring LS slope when the window was too short to difference.
        tw = scan.t_end - init_t0
        have_window = (init_t0 >= 0) & (tw > 0.25)
        accel_wm = (v_fd - init_v0) / jnp.maximum(tw, 1e-3)
        accel = jnp.where(
            have_window, accel_wm, _ring_accel(vel_ring, vel_ring_n, dt_scan)
        )
        return ekf_mod.initialize_from_odometry(
            e, imu_init_next.mean_acc, T_wi, vel, cfg.ekf,
            accel_world=accel,
            window_time=jnp.maximum(tw, 0.0),
        )

    ekf_state = jax.lax.cond(just_done, seed, lambda e: e, ekf_state)

    # --- map + pose bookkeeping ------------------------------------------
    odo = kiss_icp.KissState(
        map=core.new_map,
        pose=core.pose,
        pose_prev=jnp.where(state.odo.num_poses == 0, core.pose, state.odo.pose),
        first_pose=jnp.where(
            state.odo.num_poses == 0, core.pose, state.odo.first_pose
        ),
        num_poses=state.odo.num_poses + 1,
        threshold=core.threshold,
    )
    new_state = state._replace(odo=odo, scan_count=state.scan_count + 1)

    # carry the packet's last valid sample for the next scan
    n_valid = jnp.sum(full.mask, dtype=jnp.int32)
    last_idx = jnp.maximum(n_valid - 1, 0)
    last_imu = jnp.concatenate(
        [full.time[last_idx][None], full.gyro[last_idx], full.acc[last_idx]]
    )
    last_imu = jnp.where(n_valid > 0, last_imu, state.last_imu)

    new_state = new_state._replace(
        ekf=ekf_state, imu_init=imu_init_next, last_imu=last_imu,
        vel_ring=vel_ring, vel_ring_n=vel_ring_n,
        init_v0=init_v0, init_t0=init_t0,
    )
    out = LioOutput(
        pose=core.pose,
        ekf_pose=ekf_mod.pose_matrix(ekf_state),
        velocity=ekf_mod.velocity(ekf_state),
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
        imu_initialized=imu_init_next.done,
        used_imu=use_imu,
    )
    return new_state, out


@partial(jax.jit, static_argnames=("cfg",))
def step_jit(state: LioState, scan: Scan, packet: ekf_mod.ImuPacket, cfg: PipelineConfig):
    return step(state, scan, packet, cfg)


# donating variant for sequential drivers (callers must not reuse `state`)
step_donated = jax.jit(
    lambda state, scan, packet, cfg: step(state, scan, packet, cfg),
    static_argnames=("cfg",),
    donate_argnums=(0,),
)


def pack_imu_packet(times, gyros, accs, max_samples: int) -> ekf_mod.ImuPacket:
    """Host-side helper: pad per-scan IMU arrays into a packet."""
    import numpy as np

    times = np.asarray(times, np.float64)
    n = times.shape[0]
    assert n <= max_samples, f"{n} IMU samples > capacity {max_samples}"

    def pad(a, width):
        out = np.zeros((max_samples,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    mask = np.zeros((max_samples,), bool)
    mask[:n] = True
    return ekf_mod.ImuPacket(
        time=jnp.asarray(pad(times, 1)),
        gyro=jnp.asarray(pad(np.asarray(gyros, np.float64), 3)),
        acc=jnp.asarray(pad(np.asarray(accs, np.float64), 3)),
        mask=jnp.asarray(mask),
    )
