"""SO(3)/SE(3)/quaternion math in pure JAX (replaces Sophus + Eigen).

Conventions
-----------
* Quaternions are (w, x, y, z), matching the reference EKF state layout
  (reference include/limu/kalman/ekf.hpp:21-29).
* SE(3) tangent vectors are [v(3), w(3)] — translation part first — matching
  Sophus' exp/log convention used throughout the reference
  (reference src/utils/calculation_helpers.cpp:116-119).
* Poses are (4, 4) homogeneous matrices in f64.

All functions are closed form (Rodrigues etc.) with Taylor guards near zero
angle, so nothing here needs `expm` — including the EKF's quaternion
propagator A = exp(S(w)*dt), which the reference computes with Eigen's
unsupported MatrixFunctions (reference src/kalman/ekf.cpp:471-484, :266-267);
here it is exact via the pure-quaternion identity Xi(w)^2 = -|w|^2 I.

Functions accept arbitrary leading batch dimensions unless noted.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


from .precise import atan2_, cos_, sin_, tan_  # noqa: F401 (re-exported)


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix from (..., 3) vector (reference calculation_helpers.cpp:110-114)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `hat`: (..., 3, 3) skew matrix -> (..., 3) vector."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _safe_theta(w: jnp.ndarray):
    """(theta_sq, small_mask, safe_theta): autodiff-safe angle of (..., 3).

    jnp.linalg.norm has a NaN gradient at 0; every consumer below switches to
    a polynomial-in-theta^2 Taylor branch when small, and evaluates the exact
    branch at a clamped argument, so gradients stay finite at the identity.
    """
    sq = jnp.sum(w * w, axis=-1)
    small = sq < _EPS
    safe = jnp.sqrt(jnp.where(small, 1.0, sq))
    return sq, small, safe


def _sinc_from(sq, small, safe_theta) -> jnp.ndarray:
    """sin(theta)/theta, Taylor-guarded, gradient-safe at 0."""
    return jnp.where(small, 1.0 - sq / 6.0, sin_(safe_theta) / safe_theta)


def _sinc(theta: jnp.ndarray) -> jnp.ndarray:
    """sin(theta)/theta with Taylor guard (theta assumed >= 0 and safe)."""
    small = theta * theta < _EPS
    safe = jnp.where(small, 1.0, theta)
    return jnp.where(small, 1.0 - theta * theta / 6.0, sin_(safe) / safe)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    sq, small, safe = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc_from(sq, small, safe)[..., None, None]
    b = jnp.where(small, 0.5 - sq / 24.0, (1.0 - cos_(safe)) / jnp.where(small, 1.0, sq))[
        ..., None, None
    ]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector (pi-robust via quaternion)."""
    return quat_log(rot_to_quat(R))


def _so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """V(w) such that se3_exp([v, w]) has translation V(w) @ v."""
    sq, small, theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    safe_sq = jnp.where(small, 1.0, sq)
    safe_cube = safe_sq * theta
    b = jnp.where(small, 0.5 - sq / 24.0, (1.0 - cos_(theta)) / safe_sq)
    c = jnp.where(small, 1.0 / 6.0 - sq / 120.0, (theta - sin_(theta)) / safe_cube)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    sq, small, theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    half = jnp.where(small, 1.0, theta / 2.0)
    # 1/theta^2 - (1+cos)/(2 theta sin) == (1/theta^2)(1 - (theta/2)/tan(theta/2))
    cot = jnp.where(small, 1.0, half / tan_(half))
    coeff = jnp.where(small, 1.0 / 12.0 + sq / 720.0, (1.0 - cot) / jnp.where(small, 1.0, sq))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + coeff[..., None, None] * W2


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) twist [v, w] -> (..., 4, 4) homogeneous transform (Sophus convention)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return make_transform(R, t)


def _sincos_poly(theta_sq: jnp.ndarray):
    """(sin th / th, cos th) for th = sqrt(theta_sq), |th| <= ~3.2, by Taylor
    at th/4 + two double-angle steps — NO transcendental calls.

    Pure-arithmetic evaluation keeps the whole GN update one fused
    elementwise chain. Whether native f64 sin/cos would serve as well on
    the GPU is open (ROADMAP C2). Max abs error < 1e-14
    over the domain (series truncated at t^8 with |t| <= 0.8).
    """
    t2 = theta_sq / 16.0  # (th/4)^2
    # sin(t)/t and cos(t) at t = th/4 (Taylor to t^10/t^11; truncation
    # ~1e-11 at the domain edge t = 0.8, i.e. |th| = 3.2)
    s = 1.0 - t2 / 6.0 * (
        1.0 - t2 / 20.0 * (1.0 - t2 / 42.0 * (1.0 - t2 / 72.0 * (1.0 - t2 / 110.0)))
    )
    c = 1.0 - t2 / 2.0 * (
        1.0 - t2 / 12.0 * (1.0 - t2 / 30.0 * (1.0 - t2 / 56.0 * (1.0 - t2 / 90.0)))
    )
    # double twice: sin2 = 2 s c (with s = sin/t -> sin2/t2 = s*c, t2 = 2t)
    s, c = s * c, 2.0 * c * c - 1.0
    s, c = s * c, 2.0 * c * c - 1.0
    return s, c  # s == sin(th)/th, c == cos(th)


def se3_exp_poly(xi: jnp.ndarray) -> jnp.ndarray:
    """`se3_exp` with polynomial sin/cos and NO dot products — for hot loops
    with bounded twist norm (|w| <= ~3; ICP steps are clamped far below).

    Here W^2 = w w^T - |w|^2 I is built from scalar products and V @ v is
    expanded elementwise, so the exp fuses into its elementwise neighbours
    instead of becoming tiny matrix products (ROADMAP C2 asks whether that
    still pays on the GPU).
    """
    v, w = xi[..., :3], xi[..., 3:]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    sq = wx * wx + wy * wy + wz * wz
    sinc, cos_t = _sincos_poly(sq)
    small = sq < _EPS
    safe_sq = jnp.where(small, 1.0, sq)
    b = jnp.where(small, 0.5 - sq / 24.0, (1.0 - cos_t) / safe_sq)
    # (th - sin th)/th^3 = (1 - sinc)/th^2
    cc = jnp.where(small, 1.0 / 6.0 - sq / 120.0, (1.0 - sinc) / safe_sq)

    def rot_like(a, c):
        # I + a*W + c*(w w^T - sq I), all scalar ops
        return (
            jnp.stack([1.0 + c * (wx * wx - sq), a * -wz + c * wx * wy, a * wy + c * wx * wz], axis=-1),
            jnp.stack([a * wz + c * wx * wy, 1.0 + c * (wy * wy - sq), a * -wx + c * wy * wz], axis=-1),
            jnp.stack([a * -wy + c * wx * wz, a * wx + c * wy * wz, 1.0 + c * (wz * wz - sq)], axis=-1),
        )
    r0, r1, r2 = rot_like(sinc, b)
    R = jnp.stack([r0, r1, r2], axis=-2)
    v0, v1, v2 = rot_like(b, cc)
    t = jnp.stack(
        [jnp.sum(v0 * v, axis=-1), jnp.sum(v1 * v, axis=-1), jnp.sum(v2 * v, axis=-1)],
        axis=-1,
    )
    return make_transform(R, t)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) @ (..., 4, 4) pose composition WITHOUT a dot_general.

    The unrolled scalar form fuses into the surrounding elementwise chain
    instead of becoming a 4x4 matrix product. Use for pose math inside
    jitted loops.
    """
    rows = []
    for i in range(4):
        cols = [
            A[..., i, 0] * B[..., 0, j]
            + A[..., i, 1] * B[..., 1, j]
            + A[..., i, 2] * B[..., 2, j]
            + A[..., i, 3] * B[..., 3, j]
            for j in range(4)
        ]
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) transform -> (..., 6) twist [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = (_so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def make_transform(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def orthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation block back onto SO(3) (quaternion round-trip).

    Matrix-form pose composition accumulates a ~1e-15 non-orthonormality
    defect per step; the constant-velocity prediction feedback
    (guess = P_n (P_{n-1}^-1 P_n)) roughly DOUBLES that defect every scan,
    so it reaches O(1) within ~50 scans and destroys the trajectory. Sophus
    (the reference) stores unit quaternions and renormalizes implicitly
    (SE3 composition) — this is the explicit equivalent, applied once per
    registered scan.
    """
    R = quat_to_rot(rot_to_quat(T[..., :3, :3]))
    return make_transform(R, T[..., :3, 3])


def transform_inverse(T: jnp.ndarray) -> jnp.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    # -R^T t elementwise (fuses with its neighbours; no 3x3 product)
    ti = -jnp.stack(
        [jnp.sum(R[..., :, i] * t, axis=-1) for i in range(3)], axis=-1
    )
    return make_transform(Rt, ti)


def rotate_points(R: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation applied to (..., 3) points, ELEMENTWISE.

    Never use a matmul for f32 point geometry: at JAX's default matmul
    precision an accelerator may truncate the inputs (TF32 keeps ~10
    mantissa bits, ~4 cm at 40 m range), silently quantizing every stored
    map point. The elementwise form runs at full f32 (bit-exact vs numpy)
    and is just 9 fused multiply-adds per point.
    """
    R = R.astype(pts.dtype)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return jnp.stack(
        [
            R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z,
            R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z,
            R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z,
        ],
        axis=-1,
    )


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (4, 4) transform to (..., 3) points (reference
    calculation_helpers.cpp:121-133). Elementwise — see `rotate_points` for
    why this must not be a matmul."""
    return rotate_points(T[..., :3, :3], pts) + T[..., :3, 3].astype(pts.dtype)


def delta_pose(T_first: jnp.ndarray, T_last: jnp.ndarray) -> jnp.ndarray:
    """log(T_first^-1 @ T_last) (reference calculation_helpers.cpp:99-102)."""
    return se3_log(transform_inverse(T_first) @ T_last)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float64) -> jnp.ndarray:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.where(n < _EPS, 1.0, n)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Unit-norm-assumed quaternion -> rotation matrix (reference helper.hpp:10-17).

    Matches Eigen's Quaternion::toRotationMatrix formula, which does NOT
    normalize its input.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    one = jnp.ones_like(w)
    return jnp.stack(
        [
            jnp.stack([one - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), one - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), one - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def dquat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Analytic Jacobian of `quat_to_rot`: (..., 4, 3, 3), dR/dq_i stacked over i.

    Replaces the reference's perturbation hack (reference helper.hpp:19-33,
    which computes R(e_i) - R(q) — not a derivative). Using the true analytic
    derivative of the unit-assumed rotation formula; documented deviation.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    zero = jnp.zeros_like(w)

    def m(rows):
        return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)

    dw = m([[zero, -2 * z, 2 * y], [2 * z, zero, -2 * x], [-2 * y, 2 * x, zero]])
    dx = m([[zero, 2 * y, 2 * z], [2 * y, -4 * x, -2 * w], [2 * z, 2 * w, -4 * x]])
    dy = m([[-4 * y, 2 * x, 2 * w], [2 * x, zero, 2 * z], [-2 * w, 2 * z, -4 * y]])
    dz = m([[-4 * z, -2 * w, 2 * x], [2 * w, -4 * z, 2 * y], [2 * x, 2 * y, zero]])
    return jnp.stack([dw, dx, dy, dz], axis=-3)


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation -> (w, x, y, z) unit quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    # Four candidate solutions; pick the numerically largest pivot.
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        # clamp away from 0: sqrt's derivative at 0 is inf, and reverse-mode
        # multiplies it by the (zero) cotangent of unselected candidates,
        # yielding NaN; the clamped candidates are never the argmax pivot
        return jnp.sqrt(jnp.maximum(v, _EPS))

    # Pivot position carries t = s^2 so that t / (2 s) = s / 2, the correct
    # pivot component; off-pivot entries are the standard (m_ij +- m_ji)/(2 s).
    qw = jnp.stack([tw, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, tx, m10 + m01, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m10 + m01, ty, m21 + m12], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m21 + m12, tz], axis=-1)

    def finish(qc, t):
        s = safe_sqrt(t)
        denom = jnp.where(s < _EPS, 1.0, 2.0 * s)
        return qc / denom[..., None]

    cands = jnp.stack(
        [finish(qw, tw), finish(qx, tx), finish(qy, ty), finish(qz, tz)], axis=-2
    )  # (..., 4 candidates, 4)
    pivots = jnp.stack([tw, tx, ty, tz], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    # canonical sign: w >= 0
    q = jnp.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def quat_log(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> rotation vector (..., 3)."""
    q = jnp.where(q[..., 0:1] < 0, -q, q)  # shortest path
    vec = q[..., 1:]
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    n_sq = jnp.sum(vec * vec, axis=-1)
    small = n_sq < _EPS
    n = jnp.sqrt(jnp.where(small, 1.0, n_sq))
    angle = 2.0 * atan2_(n, w)
    scale = jnp.where(small, 2.0 / jnp.where(w < _EPS, 1.0, w), angle / n)
    return vec * scale[..., None]


def quat_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector (..., 3) -> unit quaternion."""
    sq, small, theta = _safe_theta(w)
    half = jnp.where(small, 0.0, 0.5 * theta)
    s = 0.5 * jnp.where(
        small, 1.0 - sq / 24.0, _sinc(jnp.where(small, 1.0, half))
    )  # sin(theta/2)/theta
    return jnp.concatenate([cos_(half)[..., None], w * s[..., None]], axis=-1)


def quat_from_two_vectors(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Quaternion rotating a onto b (Eigen FromTwoVectors; reference ekf.cpp:197)."""
    a = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), _EPS)
    b = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), _EPS)
    c = jnp.sum(a * b, axis=-1)
    axis = jnp.cross(a, b)
    # handle antiparallel: pick any orthogonal axis
    ortho = jnp.cross(a, jnp.where(jnp.abs(a[..., 0:1]) < 0.9, jnp.array([1.0, 0.0, 0.0], a.dtype), jnp.array([0.0, 1.0, 0.0], a.dtype)))
    anti = c < -1.0 + 1e-9
    w = jnp.sqrt(jnp.maximum(0.5 * (1.0 + c), 0.0))
    n = jnp.linalg.norm(axis, axis=-1)
    s = jnp.where(n < _EPS, 1.0, jnp.sqrt(jnp.maximum(0.5 * (1.0 - c), 0.0)) / jnp.where(n < _EPS, 1.0, n))
    vec = axis * s[..., None]
    q = jnp.concatenate([w[..., None], vec], axis=-1)
    q_anti = jnp.concatenate([jnp.zeros_like(w[..., None]), ortho / jnp.maximum(jnp.linalg.norm(ortho, axis=-1, keepdims=True), _EPS)], axis=-1)
    return quat_normalize(jnp.where(anti[..., None], q_anti, q))


def quat_xi_matrix(w: jnp.ndarray) -> jnp.ndarray:
    """The 4x4 'S' structure of the reference EKF (reference ekf.cpp:471-484).

    S_struct(w) = [[0, -w0, -w1, -w2],
                   [w0,  0, -w2,  w1],
                   [w1,  w2,  0, -w0],
                   [w2, -w1,  w0,  0]]
    satisfying S_struct(w)^2 = -|w|^2 I.
    """
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(w0)
    return jnp.stack(
        [
            jnp.stack([z, -w0, -w1, -w2], axis=-1),
            jnp.stack([w0, z, -w2, w1], axis=-1),
            jnp.stack([w1, w2, z, -w0], axis=-1),
            jnp.stack([w2, -w1, w0, z], axis=-1),
        ],
        axis=-2,
    )


def quat_propagator(w: jnp.ndarray, dt) -> jnp.ndarray:
    """Closed-form A = exp(S_struct(w) * (-dt/2)) (replaces Eigen ::exp(), ekf.cpp:266-267).

    Since S_struct(w)^2 = -|w|^2 I, exp(c*S) = cos(c|w|) I + sinc(c|w|) * c * S.
    """
    c = -0.5 * jnp.asarray(dt)
    sq, small, norm_w = _safe_theta(w)
    safe_norm = jnp.where(small, 0.0, norm_w)
    theta = safe_norm * jnp.abs(c)
    cw = safe_norm * c  # signed; |c S| eigen-angle = |c| |w|
    eye = jnp.eye(4, dtype=w.dtype)
    S = quat_xi_matrix(w)
    a = cos_(theta)
    b = _sinc(cw) * c  # sin(c|w|)/(c|w|) * c = sin(c|w|)/|w|, sign-correct
    return a[..., None, None] * eye + b[..., None, None] * S


def matmul_nowhile(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Small/medium matmul as broadcast-multiply-reduce.

    For matrices up to a few hundred on a side (the EKF's 30/170-dim
    blocks) the elementwise product-reduce fuses with its neighbors.
    Exact f64 math. Whether cuBLAS's f64 products beat it on the GPU is
    open (ROADMAP C2).
    """
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def chol_solve_unrolled(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve SPD (n, n) A X = B for small static n with a fully unrolled
    Cholesky (no XLA while-loops — see ops/icp.chol6_solve). B may be a
    vector (n,) or matrix (n, m); rows are handled vectorized."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j] - sum((L[j][k] * L[j][k] for k in range(j)), jnp.float64(0.0))
        L[j][j] = jnp.sqrt(d)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i, j] - sum((L[i][k] * L[j][k] for k in range(j)), jnp.float64(0.0))
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        acc = B[i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return jnp.stack(x)


def ang_vel_to_rot(w: jnp.ndarray, dt) -> jnp.ndarray:
    """Rotation matrix of angular velocity over dt (reference helper.hpp:35-40)."""
    return so3_exp(w * jnp.asarray(dt)[..., None] if jnp.ndim(dt) else w * dt)
