"""Robust point-to-point Gauss-Newton ICP against the voxel-hash map.

Replaces the reference's TBB parallel_reduce + Eigen LDLT inner loop
(reference src/sensors/lidar/helpers/registration.cpp) with masked batched
reductions: per-point Jacobians [I | -hat(p)] never materialize; the 6x6
normal equations are accumulated directly from closed-form blocks. The
data-dependent iteration count becomes a `lax.while_loop` with the
reference's convergence predicate ||log(estimate)|| < eps
(registration.cpp:124) and iteration cap.

Also here: the KISS-ICP adaptive threshold as a pure running-stat update
(reference src/sensors/lidar/helpers/threshold.cpp).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from . import icp_gn, lie, voxel_map
from .precise import sin_


def robust_weight(res_sq: jnp.ndarray, th) -> jnp.ndarray:
    """KISS-ICP kernel th^2 / (th + r^2)^2 (reference registration.cpp:57-58)."""
    return (th * th) / jnp.square(th + res_sq)


def chol6_solve(A, b):
    """Solve the SPD 6x6 system A x = b via a fully UNROLLED Cholesky.

    Unrolling the 6x6 factorization and both substitutions into static
    scalar ops removes every loop of jnp.linalg.cholesky + cho_solve — the
    whole solve becomes one fused scalar chain.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j] - sum((L[j][k] * L[j][k] for k in range(j)), jnp.float64(0.0))
        L[j][j] = jnp.sqrt(d)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i, j] - sum((L[i][k] * L[j][k] for k in range(j)), jnp.float64(0.0))
            L[i][j] = s * inv_d
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        y[i] = (b[i] - sum((L[i][k] * y[k] for k in range(i)), jnp.float64(0.0))) / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (
            y[i] - sum((L[k][i] * x[k] for k in range(i + 1, n)), jnp.float64(0.0))
        ) / L[i][i]
    return jnp.stack(x)


def align_clouds(src, tgt, corr_mask, kernel_th):
    """One Gauss-Newton step: weighted point-to-point normal equations.

    src/tgt: (N, 3); corr_mask selects valid correspondences. Returns
    (T (4,4) f64, xi (6,) f64): the SE(3) increment exp(solve(JtWJ, -JtWr))
    and its twist (reference registration.cpp:43-92) — callers need the
    step norm, and log(exp(x)) == x, so the twist is returned instead of
    recomputed. Accumulation is f64: the reference is all-f64 Eigen and
    world coordinates are large.
    """
    s = src.astype(jnp.float64)
    r = s - tgt.astype(jnp.float64)
    # zero masked residuals BEFORE weighting: a non-finite target (absent
    # correspondence) times a zero weight would still poison the sums
    r = jnp.where(corr_mask[:, None], r, 0.0)
    res_sq = jnp.sum(r * r, axis=-1)
    w = jnp.where(corr_mask, robust_weight(res_sq, kernel_th), 0.0)

    # J = [I | -hat(s)] per point. Closed-form blocks of JtWJ / JtWr:
    sw = jnp.sum(w)
    ws = w[:, None] * s
    wr = w[:, None] * r
    A = sw * jnp.eye(3, dtype=jnp.float64)  # sum w * I
    B = -lie.hat(jnp.sum(ws, axis=0))  # sum w * (-hat(s))
    # sum_n w s s^T via 6 masked reductions (elementwise, no f64 product)
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    sxx = jnp.sum(w * sx * sx)
    syy = jnp.sum(w * sy * sy)
    szz = jnp.sum(w * sz * sz)
    sxy = jnp.sum(w * sx * sy)
    sxz = jnp.sum(w * sx * sz)
    syz = jnp.sum(w * sy * sz)
    ss = jnp.stack(
        [
            jnp.stack([sxx, sxy, sxz]),
            jnp.stack([sxy, syy, syz]),
            jnp.stack([sxz, syz, szz]),
        ]
    )
    D = (sxx + syy + szz) * jnp.eye(3, dtype=jnp.float64) - ss
    JtWJ = jnp.block([[A, B], [B.T, D]])

    top = jnp.sum(wr, axis=0)
    bottom = jnp.sum(jnp.cross(ws, r), axis=0)  # sum w (s x r)
    JtWr = jnp.concatenate([top, bottom])

    # SPD system: unrolled Cholesky solve (the reference's LDLT on an SPD
    # matrix is numerically equivalent).
    ridge = 1e-9 * (1.0 + jnp.max(jnp.abs(jnp.diagonal(JtWJ))))
    x = chol6_solve(JtWJ + ridge * jnp.eye(6, dtype=jnp.float64), -JtWr)
    x = jnp.where(sw > 0, x, jnp.zeros_like(x))
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    return lie.se3_exp_poly(x), x


def _align_soa(sx, sy, sz, tx, ty, tz, corr_mask, kernel_th):
    """`align_clouds` on structure-of-arrays operands: source and target as
    separate (N,) f64 vectors. Avoids every (N, 3) intermediate. Same
    math, same return (T, xi)."""
    rx = jnp.where(corr_mask, sx - tx, 0.0)
    ry = jnp.where(corr_mask, sy - ty, 0.0)
    rz = jnp.where(corr_mask, sz - tz, 0.0)
    res_sq = rx * rx + ry * ry + rz * rz
    w = jnp.where(corr_mask, robust_weight(res_sq, kernel_th), 0.0)

    wsx, wsy, wsz = w * sx, w * sy, w * sz
    # all 16 normal-equation sums as ONE (16, N) reduction: separate
    # jnp.sum calls become separate fusions with per-op launch overhead
    # that dominated the iteration
    summands = jnp.stack(
        [
            w,
            wsx, wsy, wsz,
            wsx * sx, wsy * sy, wsz * sz,
            wsx * sy, wsx * sz, wsy * sz,
            w * rx, w * ry, w * rz,
            wsy * rz - wsz * ry, wsz * rx - wsx * rz, wsx * ry - wsy * rx,
        ]
    )
    (sw, Sx, Sy, Sz, sxx, syy, szz, sxy, sxz, syz,
     trx, try_, trz, bx, by, bz) = jnp.sum(summands, axis=-1)
    A = sw * jnp.eye(3, dtype=jnp.float64)
    B = -lie.hat(jnp.stack([Sx, Sy, Sz]))
    ss = jnp.stack(
        [
            jnp.stack([sxx, sxy, sxz]),
            jnp.stack([sxy, syy, syz]),
            jnp.stack([sxz, syz, szz]),
        ]
    )
    D = (sxx + syy + szz) * jnp.eye(3, dtype=jnp.float64) - ss
    JtWJ = jnp.block([[A, B], [B.T, D]])
    JtWr = jnp.stack([trx, try_, trz, bx, by, bz])

    ridge = 1e-9 * (1.0 + jnp.max(jnp.abs(jnp.diagonal(JtWJ))))
    x = chol6_solve(JtWJ + ridge * jnp.eye(6, dtype=jnp.float64), -JtWr)
    x = jnp.where(sw > 0, x, jnp.zeros_like(x))
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    return lie.se3_exp_poly(x), x


def _transform_soa(T, px, py, pz):
    """Apply (4,4) f64 T to SoA f64 points: returns (wx, wy, wz)."""
    R, t = T[:3, :3], T[:3, 3]
    wx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
    wy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
    wz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    return wx, wy, wz


class IcpResult(NamedTuple):
    pose: jnp.ndarray  # (4, 4) f64
    iterations: jnp.ndarray  # () i32
    num_correspondences: jnp.ndarray  # () i32 — from the last iteration
    residual_rms: jnp.ndarray  # () f64 — last-iteration inlier RMS distance
    converged: jnp.ndarray  # () bool — twist-norm convergence reached (an
    # exhausted refetch/iteration budget returns False: round-1 weakness #8,
    # "silent non-convergence")


def icp_registration(
    m: voxel_map.VoxelMap,
    points,  # (N, 3) f32 sensor-frame source
    mask,  # (N,) bool
    init_guess,  # (4, 4) f64
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    max_iterations: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
) -> IcpResult:
    """The ICP loop (reference registration.cpp:94-130).

    Recomputes world-frame points from the composed transform each iteration
    (equivalent to the reference's incremental re-transform), finds
    correspondences in the map, and composes GN increments until the twist
    norm of the last increment drops below `estimation_threshold`.
    """
    max_d2 = max_corresp_dist * max_corresp_dist
    # SoA f64 source coordinates: the loop never materializes an (N, 3)
    # tensor
    px = points[:, 0].astype(jnp.float64)
    py = points[:, 1].astype(jnp.float64)
    pz = points[:, 2].astype(jnp.float64)

    # Candidate neighborhoods are fetched once per OUTER round — the hash
    # probes + HBM gathers dominate NN cost, while per-iteration distance
    # reductions over the cached (N, 27K, 3) block are VPU-only. The inner
    # loop iterates with fixed candidates until convergence or until the
    # accumulated correction drifts beyond half a voxel (candidates stale);
    # the outer loop refetches at the current pose. Two loops (instead of a
    # cond-gated refetch inside one loop) keep the fetch out of the iteration
    # body: under vmap lax.cond executes both branches, which would re-gather
    # every iteration for every stream. Deviation from the reference, which
    # re-queries the map every iteration (registration.cpp:108-126);
    # identical results while corrections stay within the 3x3x3 shell.
    refetch_d2 = (0.5 * map_cfg.voxel_size) ** 2
    # every outer round runs >= 1 inner GN iteration (the inner while's
    # first body always executes: stale starts False, converged was checked
    # by the outer cond), so `max_iterations` outer rounds suffice for the
    # iteration budget to bind — max_iterations is the real cap, not the
    # refetch count (round-3 advisor: a hard-coded refetch cap silently
    # shadowed max_iterations)
    max_refetch = max_iterations
    min_corr = min_correspondences
    map_cfg_max_step = max_step_norm

    def fetch(T):
        wx, wy, wz = _transform_soa(T, px, py, pz)
        world = jnp.stack(
            [wx.astype(jnp.float32), wy.astype(jnp.float32), wz.astype(jnp.float32)],
            axis=-1,
        )
        cand, cand_valid = voxel_map.gather_candidates(m, world, mask, map_cfg)
        cx, cy, cz = voxel_map.deinterleave_candidates(cand)
        return cx, cy, cz, cand_valid

    def inner(carry):
        j, T_icp, converged, n_corr, rms, cx, cy, cz, cand_valid, anchor_t = carry

        def inner_cond(state):
            j, _, converged, _, _, stale = state
            return (j < max_iterations) & ~converged & ~stale

        def inner_body(state):
            j, T_icp, _, _, _, _ = state
            T = lie.compose(T_icp, init_guess)
            wx, wy, wz = _transform_soa(T, px, py, pz)
            tx, ty, tz, d2, found = voxel_map.nn_from_candidates_soa(
                cx, cy, cz, cand_valid, wx.astype(jnp.float32),
                wy.astype(jnp.float32), wz.astype(jnp.float32), mask
            )
            corr = found & (d2 < max_d2)
            estimate, xi = _align_soa(
                wx, wy, wz, tx.astype(jnp.float64), ty.astype(jnp.float64),
                tz.astype(jnp.float64), corr, kernel_th
            )
            n_corr = jnp.sum(corr, dtype=jnp.int32)
            # degraded-mode guards (no reference equivalent — its LDLT on a
            # near-singular system teleports the pose): freeze on starved
            # correspondences, clamp runaway steps
            step = jnp.linalg.norm(xi)
            scale = jnp.where(
                step > map_cfg_max_step, map_cfg_max_step / step, 1.0
            )
            ok = n_corr >= min_corr
            estimate = jnp.where(
                ok,
                jnp.where(scale < 1.0, lie.se3_exp_poly(xi * scale), estimate),
                jnp.eye(4, dtype=jnp.float64),
            )
            rms = jnp.sqrt(
                jnp.sum(jnp.where(corr, d2, 0.0)) / jnp.maximum(n_corr, 1)
            ).astype(jnp.float64)
            T_new = lie.compose(estimate, T_icp)
            converged = (~ok) | (
                jnp.minimum(step, map_cfg_max_step) < estimation_threshold
            )
            drift = jnp.sum(((lie.compose(T_new, init_guess))[:3, 3] - anchor_t) ** 2)
            stale = ~converged & (drift > refetch_d2)
            return j + 1, T_new, converged, n_corr, rms, stale

        j, T_icp, converged, n_corr, rms, _ = jax.lax.while_loop(
            inner_cond, inner_body, (j, T_icp, converged, n_corr, rms, jnp.asarray(False))
        )
        return j, T_icp, converged, n_corr, rms

    def outer_cond(state):
        r, j, _, converged, _, _ = state
        return (r < max_refetch) & (j < max_iterations) & ~converged

    def outer_body(state):
        r, j, T_icp, converged, n_corr, rms = state
        T = lie.compose(T_icp, init_guess)
        cx, cy, cz, cand_valid = fetch(T)
        j, T_icp, converged, n_corr, rms = inner(
            (j, T_icp, converged, n_corr, rms, cx, cy, cz, cand_valid, T[:3, 3])
        )
        return r + 1, j, T_icp, converged, n_corr, rms

    init = (
        jnp.int32(0),
        jnp.int32(0),
        jnp.eye(4, dtype=jnp.float64),
        jnp.asarray(False),
        jnp.int32(0),
        jnp.float64(0.0),
    )
    _, j, T_icp, converged, n_corr, rms = jax.lax.while_loop(
        outer_cond, outer_body, init
    )

    # empty map: return the guess untouched (reference registration.cpp:99-100)
    empty = voxel_map.num_voxels(m) == 0
    pose = jnp.where(empty, init_guess, lie.compose(T_icp, init_guess))
    return IcpResult(pose, j, n_corr, rms, converged & ~empty)


def icp_registration_unrolled(
    m: voxel_map.VoxelMap,
    points,  # (N, 3) f32 sensor-frame source
    mask,  # (N,) bool
    init_guess,  # (4, 4) f64
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    n_outer: int,
    n_inner: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
) -> IcpResult:
    """Fixed-unroll GN-ICP for batched (vmap) execution.

    A vmapped `lax.while_loop` runs EVERY stream to the max iteration count
    across the batch (SURVEY §7 hard part 3): one hard scan stalls all
    streams, and under vmap the data-dependent loop also blocks XLA from
    pipelining across iterations. Here the schedule is static — `n_outer`
    candidate fetches x `n_inner` GN iterations, the same math per iteration
    as `icp_registration` — so the batched program has no data-dependent
    control flow at all. Converged streams freeze their pose via masking
    (early-exit masking); the wasted masked iterations are the price of a
    bounded, batch-friendly schedule.
    """
    max_d2 = max_corresp_dist * max_corresp_dist
    px = points[:, 0].astype(jnp.float64)
    py = points[:, 1].astype(jnp.float64)
    pz = points[:, 2].astype(jnp.float64)
    eye = jnp.eye(4, dtype=jnp.float64)

    T_icp = eye
    converged = jnp.asarray(False)
    n_corr = jnp.int32(0)
    rms = jnp.float64(0.0)
    iters = jnp.int32(0)

    for _ in range(n_outer):
        T = lie.compose(T_icp, init_guess)
        fx, fy, fz = _transform_soa(T, px, py, pz)
        world_f = jnp.stack(
            [fx.astype(jnp.float32), fy.astype(jnp.float32), fz.astype(jnp.float32)],
            axis=-1,
        )
        cand, cand_valid = voxel_map.gather_candidates(m, world_f, mask, map_cfg)
        cx, cy, cz = voxel_map.deinterleave_candidates(cand)
        for _ in range(n_inner):
            T = lie.compose(T_icp, init_guess)
            wx, wy, wz = _transform_soa(T, px, py, pz)
            tx, ty, tz, d2, found = voxel_map.nn_from_candidates_soa(
                cx, cy, cz, cand_valid, wx.astype(jnp.float32),
                wy.astype(jnp.float32), wz.astype(jnp.float32), mask
            )
            corr = found & (d2 < max_d2)
            estimate, xi = _align_soa(
                wx, wy, wz, tx.astype(jnp.float64), ty.astype(jnp.float64),
                tz.astype(jnp.float64), corr, kernel_th
            )
            nc = jnp.sum(corr, dtype=jnp.int32)
            step = jnp.linalg.norm(xi)
            scale = jnp.where(step > max_step_norm, max_step_norm / step, 1.0)
            ok = nc >= min_correspondences
            estimate = jnp.where(
                ok,
                jnp.where(scale < 1.0, lie.se3_exp_poly(xi * scale), estimate),
                eye,
            )
            active = ~converged
            T_icp = jnp.where(active, lie.compose(estimate, T_icp), T_icp)
            n_corr = jnp.where(active, nc, n_corr)
            rms = jnp.where(
                active,
                jnp.sqrt(
                    jnp.sum(jnp.where(corr, d2, 0.0)) / jnp.maximum(nc, 1)
                ).astype(jnp.float64),
                rms,
            )
            iters = iters + active.astype(jnp.int32)
            converged = converged | (~ok) | (
                jnp.minimum(step, max_step_norm) < estimation_threshold
            )

    empty = voxel_map.num_voxels(m) == 0
    pose = jnp.where(empty, init_guess, lie.compose(T_icp, init_guess))
    return IcpResult(pose, iters, n_corr, rms, converged & ~empty)


# ---------------------------------------------------------------------------
# Fused registration: n_inner f32 GN iterations per candidate fetch
# (ops/icp_gn.py). Same outer refetch semantics as icp_registration; all
# inner math f32 on centered coords.
# ---------------------------------------------------------------------------


def _fused_round(m, px, py, pz, mask, qmask_t, T, map_cfg: MapConfig,
                 kernel_th, max_d2, estimation_threshold,
                 min_correspondences, max_step_norm, refetch_d2,
                 n_inner: int):
    """One fetch + n_inner fused GN iterations at pose T.

    Returns (T_delta (4,4) f64 correction in the world frame, n_corr i32,
    rms f64, iters i32, converged, stale)."""
    wx, wy, wz = _transform_soa(T, px, py, pz)
    # anchor = masked query centroid: guaranteed near the DATA (the guess
    # translation is not, e.g. a far-from-origin map under an identity
    # guess), which the f32 centering requires
    nq = jnp.maximum(jnp.sum(mask), 1).astype(jnp.float64)
    anchor_raw = jnp.stack(
        [
            jnp.sum(jnp.where(mask, wx, 0.0)) / nq,
            jnp.sum(jnp.where(mask, wy, 0.0)) / nq,
            jnp.sum(jnp.where(mask, wz, 0.0)) / nq,
        ]
    )
    # (the voxel-local packed decode accepts any anchor — queries and
    # candidates are centered on this same value on both paths)
    anchor64 = anchor_raw.astype(jnp.float32).astype(jnp.float64)
    q = jnp.stack(
        [
            (wx - anchor64[0]).astype(jnp.float32),
            (wy - anchor64[1]).astype(jnp.float32),
            (wz - anchor64[2]).astype(jnp.float32),
        ]
    )
    world_f = jnp.stack(
        [wx.astype(jnp.float32), wy.astype(jnp.float32),
         wz.astype(jnp.float32)], axis=-1,
    )
    if map_cfg.packed_nn:
        cand = voxel_map.gather_candidate_planes_packed(
            m, world_f, mask, map_cfg, anchor64
        )
    else:
        cand = voxel_map.gather_candidate_planes(
            m, world_f, mask, map_cfg, anchor64.astype(jnp.float32)
        )
    scal = jnp.stack(
        [
            jnp.asarray(kernel_th, jnp.float64),
            jnp.asarray(max_d2, jnp.float64),
            jnp.asarray(estimation_threshold, jnp.float64),
            jnp.asarray(min_correspondences, jnp.float64),
            jnp.asarray(max_step_norm, jnp.float64),
            jnp.asarray(refetch_d2, jnp.float64),
        ]
    ).astype(jnp.float32)
    R, t, nc, rms, it, conv, stale = icp_gn.fused_gn(
        q, qmask_t, cand, scal, n_inner
    )
    # de-center: T_world = Trans(anchor) T_centered Trans(-anchor)
    Rd = R.astype(jnp.float64)
    td = (
        t.astype(jnp.float64)
        + anchor64
        - jnp.stack([jnp.sum(Rd[i] * anchor64) for i in range(3)])
    )
    T_delta = lie.make_transform(Rd, td)
    return (T_delta, nc.astype(jnp.int32), rms.astype(jnp.float64),
            it.astype(jnp.int32), conv, stale)


def icp_registration_fused(
    m: voxel_map.VoxelMap,
    points,  # (N, 3) f32 sensor-frame source
    mask,  # (N,) bool
    init_guess,  # (4, 4) f64
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    max_iterations: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
    n_inner: int = 6,
) -> IcpResult:
    """`icp_registration` with the fused f32 inner loop — f64 facade
    over `icp_registration_fused_pair` (one float-float split of the guess
    in, one recombine out; the loop itself carries no f64)."""
    g = init_guess.reshape(16)
    gh = g.astype(jnp.float32)
    gl = (g - gh.astype(jnp.float64)).astype(jnp.float32)
    gh4, gl4 = gh.reshape(4, 4), gl.reshape(4, 4)
    R9, th, tl, iters, n_corr, rms, converged = icp_registration_fused_pair(
        m, points, mask, gh4[:3, :3].reshape(9), gh4[:3, 3], gl4[:3, 3],
        max_corresp_dist, kernel_th, map_cfg, max_iterations,
        estimation_threshold, min_correspondences, max_step_norm, n_inner,
    )
    pose = lie.make_transform(
        R9.reshape(3, 3).astype(jnp.float64),
        th.astype(jnp.float64) + tl.astype(jnp.float64),
    )
    return IcpResult(pose, iters, n_corr, rms.astype(jnp.float64), converged)


def icp_registration_fused_pair(
    m: voxel_map.VoxelMap,
    points,  # (N, 3) f32 sensor-frame source
    mask,  # (N,) bool
    guess_R9,  # (9,) f32 row-major rotation of the initial guess
    guess_th,  # (3,) f32 guess translation hi
    guess_tl,  # (3,) f32 guess translation lo (float-float pair)
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    max_iterations: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
    n_inner: int = 6,
):
    """The fused ICP loop with NO f64 anywhere: the accumulated pose rides
    the while loop as (R f32, t float-float) and each outer round's
    de-centering + composition happens inside `fused_gn_carry`.

    Outer `lax.while_loop` refetches candidates at the current pose (same
    staleness semantics as `icp_registration`: the kernel freezes once its
    accumulated correction drifts beyond half a voxel and reports `stale`);
    each round runs up to `n_inner` GN iterations.

    Returns (R9 (9,) f32, t_hi (3,), t_lo (3,), iters i32, n_corr i32,
    rms f32, converged bool) — the final world pose as a float-float pair.
    """
    max_d2 = max_corresp_dist * max_corresp_dist
    refetch_d2 = (0.5 * map_cfg.voxel_size) ** 2
    # enough refetch rounds for the iteration budget to bind (each round
    # runs >= 1 GN iteration while unconverged, and may stale after
    # just 1): max_iterations is the real cap on BOTH backends
    # (round-3 advisor finding)
    max_refetch = max_iterations
    px = points[:, 0].astype(jnp.float32)
    py = points[:, 1].astype(jnp.float32)
    pz = points[:, 2].astype(jnp.float32)
    qmask_t = mask.astype(jnp.float32)
    scal = jnp.stack([
        jnp.asarray(kernel_th, jnp.float64),
        jnp.asarray(max_d2, jnp.float64),
        jnp.asarray(estimation_threshold, jnp.float64),
        jnp.asarray(min_correspondences, jnp.float64),
        jnp.asarray(max_step_norm, jnp.float64),
        jnp.asarray(refetch_d2, jnp.float64),
    ]).astype(jnp.float32)

    def cond(state):
        r, iters, _, _, _, converged, _, _ = state
        return (r < max_refetch) & (iters < max_iterations) & ~converged

    def body(state):
        r, iters, R9, th, tl, converged, n_corr, rms = state
        # world-frame source at the current pose (f32 — the GN loop is
        # f32 on centered coordinates anyway; see _fused_round's anchor
        # rationale for why centering keeps this exact enough)
        t0, t1, t2 = th[0] + tl[0], th[1] + tl[1], th[2] + tl[2]
        wx = R9[0] * px + R9[1] * py + R9[2] * pz + t0
        wy = R9[3] * px + R9[4] * py + R9[5] * pz + t1
        wz = R9[6] * px + R9[7] * py + R9[8] * pz + t2
        nq = jnp.maximum(jnp.sum(mask), 1).astype(jnp.float32)
        anchor = jnp.stack([
            jnp.sum(jnp.where(mask, wx, 0.0)),
            jnp.sum(jnp.where(mask, wy, 0.0)),
            jnp.sum(jnp.where(mask, wz, 0.0)),
        ]) / nq
        q = jnp.stack([wx - anchor[0], wy - anchor[1], wz - anchor[2]])
        world_f = jnp.stack([wx, wy, wz], axis=-1)
        if map_cfg.packed_nn:
            cand = voxel_map.gather_candidate_planes_packed(
                m, world_f, mask, map_cfg, anchor
            )
        else:
            cand = voxel_map.gather_candidate_planes(
                m, world_f, mask, map_cfg, anchor
            )
        carry = jnp.concatenate([R9, th, tl, anchor])
        R9n, thn, tln, nc, rms2, it, conv, _stale = icp_gn.fused_gn_carry(
            q, qmask_t, cand, scal, carry, n_inner
        )
        return (r + 1, iters + it.astype(jnp.int32), R9n, thn, tln, conv,
                nc.astype(jnp.int32), rms2)

    init = (
        jnp.int32(0), jnp.int32(0),
        guess_R9.astype(jnp.float32), guess_th.astype(jnp.float32),
        guess_tl.astype(jnp.float32),
        jnp.asarray(False), jnp.int32(0), jnp.float32(0.0),
    )
    _, iters, R9, th, tl, converged, n_corr, rms = jax.lax.while_loop(
        cond, body, init
    )
    empty = voxel_map.num_voxels(m) == 0
    R9 = jnp.where(empty, guess_R9.astype(jnp.float32), R9)
    th = jnp.where(empty, guess_th.astype(jnp.float32), th)
    tl = jnp.where(empty, guess_tl.astype(jnp.float32), tl)
    return R9, th, tl, iters, n_corr, rms, converged & ~empty


def icp_registration_fused_unrolled(
    m: voxel_map.VoxelMap,
    points,
    mask,
    init_guess,
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    n_outer: int,
    n_inner: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
) -> IcpResult:
    """Fixed-unroll fused ICP for BATCHED (vmap) execution: `n_outer`
    static fetches x `n_inner` GN iterations, early-exit masking."""
    max_d2 = max_corresp_dist * max_corresp_dist
    refetch_d2 = (0.5 * map_cfg.voxel_size) ** 2
    px = points[:, 0].astype(jnp.float64)
    py = points[:, 1].astype(jnp.float64)
    pz = points[:, 2].astype(jnp.float64)
    qmask_t = mask.astype(jnp.float32)

    T_icp = jnp.eye(4, dtype=jnp.float64)
    converged = jnp.asarray(False)
    n_corr = jnp.int32(0)
    rms = jnp.float64(0.0)
    iters = jnp.int32(0)
    for _ in range(n_outer):
        T = lie.compose(T_icp, init_guess)
        T_delta, nc, rms2, it, conv, _stale = _fused_round(
            m, px, py, pz, mask, qmask_t, T, map_cfg, kernel_th, max_d2,
            estimation_threshold, min_correspondences, max_step_norm,
            refetch_d2, n_inner,
        )
        active = ~converged
        T_icp = jnp.where(active, lie.compose(T_delta, T_icp), T_icp)
        n_corr = jnp.where(active, nc, n_corr)
        rms = jnp.where(active, rms2, rms)
        iters = iters + jnp.where(active, it, 0)
        converged = converged | conv

    empty = voxel_map.num_voxels(m) == 0
    pose = jnp.where(empty, init_guess, lie.compose(T_icp, init_guess))
    return IcpResult(pose, iters, n_corr, rms, converged & ~empty)


def registration_dispatch(m, source, source_mask, init_guess, sigma,
                          map_cfg, icp_cfg) -> IcpResult:
    """Select the registration variant from the config: gn_backend
    ("fused" f32 loop vs "xla" f64 loops) x schedule (data-dependent
    while loop vs fixed unroll for batched execution). max_corr = 3 sigma,
    kernel = sigma / 3 (reference icp.cpp:74-76)."""
    max_corr = 3.0 * sigma
    kth = sigma / 3.0
    if icp_cfg.gn_backend == "fused":
        if icp_cfg.batch_unroll_outer > 0:
            return icp_registration_fused_unrolled(
                m, source, source_mask, init_guess, max_corr, kth, map_cfg,
                icp_cfg.batch_unroll_outer,
                icp_cfg.batch_unroll_inner or icp_cfg.fused_inner,
                icp_cfg.estimation_threshold,
                icp_cfg.min_correspondences, icp_cfg.max_step_norm,
            )
        return icp_registration_fused(
            m, source, source_mask, init_guess, max_corr, kth, map_cfg,
            icp_cfg.max_iterations, icp_cfg.estimation_threshold,
            icp_cfg.min_correspondences, icp_cfg.max_step_norm,
            icp_cfg.fused_inner,
        )
    if icp_cfg.batch_unroll_outer > 0:
        return icp_registration_unrolled(
            m, source, source_mask, init_guess, max_corr, kth, map_cfg,
            icp_cfg.batch_unroll_outer, icp_cfg.batch_unroll_inner,
            icp_cfg.estimation_threshold,
            icp_cfg.min_correspondences, icp_cfg.max_step_norm,
        )
    return icp_registration(
        m, source, source_mask, init_guess, max_corr, kth, map_cfg,
        icp_cfg.max_iterations, icp_cfg.estimation_threshold,
        icp_cfg.min_correspondences, icp_cfg.max_step_norm,
    )


# ---------------------------------------------------------------------------
# Adaptive threshold (reference threshold.cpp, threshold.hpp)
# ---------------------------------------------------------------------------


class ThresholdState(NamedTuple):
    model_error_sq: jnp.ndarray  # () f64 running sum
    num_samples: jnp.ndarray  # () i32
    model_deviation: jnp.ndarray  # (4, 4) f64


def threshold_init() -> ThresholdState:
    return ThresholdState(
        jnp.float64(0.0), jnp.int32(0), jnp.eye(4, dtype=jnp.float64)
    )


def compute_model_error(model_dev, max_range):
    """2 * max_range * sin(theta/2) + ||t|| (reference threshold.cpp:5-12)."""
    theta = jnp.linalg.norm(lie.so3_log(model_dev[:3, :3]))
    return 2.0 * max_range * sin_(theta / 2.0) + jnp.linalg.norm(model_dev[:3, 3])


def compute_threshold(
    state: ThresholdState,
    has_moved,
    initial_threshold: float,
    min_motion_th: float,
    max_range: float,
):
    """Functional version of get_adaptive_threshold (reference icp.cpp:138-144
    + threshold.cpp:16-29): accumulates the previous frame's model deviation
    and returns sigma. When not yet moved, returns the initial threshold and
    leaves the stats untouched.
    """
    err = compute_model_error(state.model_deviation, max_range)
    accumulate = has_moved & (err > min_motion_th)
    new_sum = jnp.where(accumulate, state.model_error_sq + err * err, state.model_error_sq)
    new_n = jnp.where(accumulate, state.num_samples + 1, state.num_samples)

    sigma_adaptive = jnp.sqrt(new_sum / jnp.maximum(new_n, 1))
    sigma = jnp.where(
        has_moved & (new_n >= 1), sigma_adaptive, jnp.float64(initial_threshold)
    )
    return ThresholdState(new_sum, new_n, state.model_deviation), sigma


def update_model_deviation(state: ThresholdState, deviation) -> ThresholdState:
    return ThresholdState(state.model_error_sq, state.num_samples, deviation)
