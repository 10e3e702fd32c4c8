"""Motion compensation kernels.

Constant-velocity deskew replaces the reference's TBB per-point loop
(reference src/sensors/lidar/helpers/deskew.cpp:10-29): every point moves by
exp((tau_i - 0.5) * twist) where twist = log(T_start^-1 T_end) and tau is the
normalized in-scan time. Here the per-point SE(3) exponential is evaluated
batched on the VPU.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lie


def constant_velocity_deskew(
    points: jnp.ndarray,  # (N, 3) f32, sensor frame
    tau: jnp.ndarray,  # (N,) f32 normalized time in [0, 1]
    pose_start: jnp.ndarray,  # (4, 4) f64
    pose_end: jnp.ndarray,  # (4, 4) f64
    mid_pose_timestamp: float = 0.5,  # reference deskew.hpp ctor
) -> jnp.ndarray:
    """Batched exp((tau - mid) * twist) @ p (reference deskew.cpp:20-26)."""
    twist = lie.delta_pose(pose_start, pose_end)  # (6,) f64
    scale = (tau.astype(jnp.float64) - mid_pose_timestamp)[:, None]
    motions = lie.se3_exp(scale * twist[None, :])  # (N, 4, 4)
    p = points.astype(jnp.float64)
    out = (motions[:, :3, :3] @ p[:, :, None])[:, :, 0] + motions[:, :3, 3]
    return out.astype(points.dtype)


def constant_velocity_deskew_fast(
    points: jnp.ndarray,  # (N, 3) f32, sensor frame
    tau: jnp.ndarray,  # (N,) f32 normalized time in [0, 1]
    pose_start: jnp.ndarray,  # (4, 4) f64
    pose_end: jnp.ndarray,  # (4, 4) f64
    mid_pose_timestamp: float = 0.5,
) -> jnp.ndarray:
    """f32 closed form of exp((tau - mid) * twist) @ p without materializing
    per-point 4x4 matrices.

    All N points share the twist AXIS — only the scale s_i = tau_i - mid
    varies — so the Rodrigues rotation and the SE(3) V-matrix translation
    reduce to a handful of fused elementwise ops with two precomputed cross
    products:

      p'  = p cos(th) + (k x p) sin(th) + k (k.p)(1 - cos(th))
            + s v + a (w x v) + b (w x (w x v))
      th  = s |w|,  a = (1-cos th)/|w|^2,  b = (th - sin th)/|w|^3

    f32 is exact enough here: the per-scan twist is small (sub-voxel), and
    the result feeds a robust ICP, and f32 moves half the bytes of the
    f64 matrix path at 131k points.
    """
    twist = lie.delta_pose(pose_start, pose_end).astype(jnp.float32)
    v, w = twist[:3], twist[3:]
    wn = jnp.linalg.norm(w)
    tiny = wn < 1e-8
    wn_safe = jnp.where(tiny, 1.0, wn)
    k = w / wn_safe

    s = tau.astype(jnp.float32) - jnp.float32(mid_pose_timestamp)  # (N,)
    th = s * wn
    c, si = jnp.cos(th), jnp.sin(th)

    p = points.astype(jnp.float32)
    kxp = jnp.cross(jnp.broadcast_to(k, p.shape), p)
    # elementwise dot: `p @ k` may run at reduced precision (lie.rotate_points)
    kdp = p[:, 0] * k[0] + p[:, 1] * k[1] + p[:, 2] * k[2]
    rot = p * c[:, None] + kxp * si[:, None] + k[None, :] * (kdp * (1.0 - c))[:, None]

    wxv = jnp.cross(w, v)
    wwxv = jnp.cross(w, wxv)
    a = jnp.where(tiny, 0.5 * s * s, (1.0 - c) / (wn_safe * wn_safe))
    b = jnp.where(tiny, s * s * s / 6.0, (th - si) / (wn_safe**3))
    trans = s[:, None] * v[None, :] + a[:, None] * wxv[None, :] + b[:, None] * wwxv[None, :]
    return rot + trans


def deskew_from_scalars(
    points: jnp.ndarray,  # (N, 3) f32, sensor frame
    tau: jnp.ndarray,  # (N,) f32 normalized time in [0, 1]
    sc: jnp.ndarray,  # (13,) f32 twist pieces from the pose_pre kernel
    mid_pose_timestamp: float = 0.5,
) -> jnp.ndarray:
    """`constant_velocity_deskew_fast`'s vector stage with the twist scalars
    precomputed by the pose_pre chain (ops/pose_chain.py):
    sc = [|w|, k(3), v(3), w x v(3), w x (w x v)(3)]. An all-zero sc is the
    identity (th = 0 -> rot = p, trans = 0), so the num_poses/deskew gating
    lives in the kernel and no lax.cond wraps the vector math."""
    wn = sc[0]
    k = sc[1:4]
    v = sc[4:7]
    wxv = sc[7:10]
    wwxv = sc[10:13]

    s = tau.astype(jnp.float32) - jnp.float32(mid_pose_timestamp)
    th = s * wn
    c, si = jnp.cos(th), jnp.sin(th)

    p = points.astype(jnp.float32)
    kxp = jnp.cross(jnp.broadcast_to(k, p.shape), p)
    kdp = p[:, 0] * k[0] + p[:, 1] * k[1] + p[:, 2] * k[2]
    rot = p * c[:, None] + kxp * si[:, None] + k[None, :] * (kdp * (1.0 - c))[:, None]

    tiny = wn < 1e-8
    wn_safe = jnp.where(tiny, 1.0, wn)
    a = jnp.where(tiny, 0.5 * s * s, (1.0 - c) / (wn_safe * wn_safe))
    b = jnp.where(tiny, s * s * s / 6.0, (th - si) / (wn_safe**3))
    trans = s[:, None] * v[None, :] + a[:, None] * wxv[None, :] + b[:, None] * wwxv[None, :]
    return rot + trans
