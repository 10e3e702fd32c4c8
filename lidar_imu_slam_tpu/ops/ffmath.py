"""Float-float (two-f32) scalar arithmetic.

Pose translations grow to km scale over a drive while per-scan increments
stay at mm scale. The fast step's f32 chains (ops/pose_chain.py,
ops/icp_gn.py) carry them as (hi, lo) f32 pairs with ~2^-48 relative
precision — well beyond the f32 point math that consumes them and ~1e6x
below the per-scan ICP noise floor.

The error-free transforms (Knuth two_sum, Dekker two_prod) require strict
IEEE f32 semantics: no reassociation of the error terms (a fused
multiply-add only makes Dekker's products more exact). tests/
test_pose_chain.py pins them against f64. They are plain jnp functions of
scalars or arrays.

No reference counterpart: the reference is all-f64 Eigen on CPU
(reference src/utils/calculation_helpers.cpp). Whether native f64 makes
this carrier unnecessary is an open design question (ROADMAP C1).
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 (Dekker splitter for the 24-bit f32 mantissa)


def check_f32(what: str, *xs):
    """The float-float chains are f32 by design: refuse other operands
    (under jax_enable_x64 an f64 input would silently promote them)."""
    for x in xs:
        if x.dtype != jnp.float32:
            raise TypeError(f"{what} operands must be float32, got {x.dtype}")


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """two_sum assuming |a| >= |b| (3 ops instead of 6)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """Error-free a * b via Dekker splitting: (p, e), p + e == a * b."""
    p = a * b
    ah = a * _SPLIT
    ah = ah - (ah - a)
    al = a - ah
    bh = b * _SPLIT
    bh = bh - (bh - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def add(xh, xl, yh, yl):
    """(xh+xl) + (yh+yl) -> normalized (hi, lo)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def add_f(xh, xl, y):
    """ff + f32."""
    s, e = two_sum(xh, y)
    return quick_two_sum(s, e + xl)


def sub(xh, xl, yh, yl):
    return add(xh, xl, -yh, -yl)


def sub_f(xh, xl, y):
    return add_f(xh, xl, -y)


def mul_f(xh, xl, y):
    """ff * f32."""
    p, e = two_prod(xh, y)
    return quick_two_sum(p, e + xl * y)


def mat3_apply_ff(R, th, tl):
    """(3,3)-of-scalars R applied to an ff 3-vector: rows of sum_j R_ij*t_j
    accumulated in ff. R is a nested tuple/list of f32 scalars; th/tl are
    3-tuples of f32 scalars. Returns (hi 3-tuple, lo 3-tuple)."""
    oh, ol = [], []
    for i in range(3):
        h, l = mul_f(th[0], tl[0], R[i][0])
        h2, l2 = mul_f(th[1], tl[1], R[i][1])
        h, l = add(h, l, h2, l2)
        h2, l2 = mul_f(th[2], tl[2], R[i][2])
        h, l = add(h, l, h2, l2)
        oh.append(h)
        ol.append(l)
    return oh, ol


def atan2_pos(s, c):
    """atan2(s, c) for s >= 0 (rotation angle in [0, pi)), f32-exact.

    Built from sin/cos/division only: seeds with the half-angle form
    theta0 = 2*atan(u), u = s/(1+c), evaluating atan via the reciprocal
    identity (atan(u) = pi/2 - atan(1/u) for u > 1, branch-free select) and
    a degree-7 odd series on w = min(u, 1/u) <= 1, then polishes TWICE with
    the hardware sin/cos: theta += sin(theta - theta0) = s*cos(theta0) -
    c*sin(theta0) (cubic convergence per polish). Max error ~1 ulp over
    theta in [0, pi - 1e-3] (verified numerically)."""
    u = s / (1.0 + c)
    inv = 1.0 / jnp.maximum(u, 1e-30)
    big = u > 1.0
    w = jnp.where(big, inv, u)
    w2 = w * w
    at = w * (1.0 - w2 * (1.0 / 3.0 - w2 * (1.0 / 5.0 - w2 / 7.0)))
    th = 2.0 * jnp.where(big, jnp.float32(jnp.pi / 2) - at, at)
    th = th + (s * jnp.cos(th) - c * jnp.sin(th))
    return th + (s * jnp.cos(th) - c * jnp.sin(th))
