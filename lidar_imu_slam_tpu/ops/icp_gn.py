"""Fused Gauss-Newton ICP inner loop: `n_inner` GN iterations per
candidate fetch, all f32 on centred coordinates, as plain `jnp`/`lax`.

Each iteration is three reductions XLA fuses across the whole device:
the nearest-neighbour search (one variadic reduction over the candidate
axis), the weighted normal-equation sums (one reduction over the
queries), and a scalar 6x6 Cholesky solve + Rodrigues update.

This is the re-design of the reference's hot loop (reference
src/sensors/lidar/helpers/registration.cpp:43-130 +
voxel_hash_map.cpp:104-130): the TBB parallel_reduce becomes device
reductions, the Eigen LDLT an unrolled scalar Cholesky, Sophus exp a
scalar Rodrigues.

Precision: everything is f32 on CENTERED coordinates (the caller subtracts
an anchor near the data from queries and candidates, so coordinates are
local ~+-range). The 6x6 normal equations are Jacobi-preconditioned (the
rotational block scales with coordinate^2; a raw f32 Cholesky at 80 m
coordinates loses ~4 digits). Validated against the f64 XLA path
(tests/test_pallas_gn.py).

Layouts (N queries, NC candidate slots per query):
  q      (3, N) f32      centered query coordinates (x, y, z planes)
  qmask  (N,)   f32      1.0 = valid query
  cand   (3, NC, N) f32  candidate coordinates; +inf = invalid slot
  scal   (6,) f32: [kernel_th, max_d2, est_th, min_corr, max_step, stale_d2]
`stale` means the accumulated translation drifted beyond stale_d2
(candidates need a refetch) — further iterations freeze, mirroring the
XLA path's inner-loop exit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import ffmath as ff


def nearest_candidate(wx, wy, wz, cx, cy, cz):
    """Nearest candidate of each query: a reduction over the candidate axis.

    w* (N,) f32 query coordinates; c* (NC, N) f32 candidate planes (+inf =
    empty slot). Returns (best_d2, bx, by, bz), each (N,). The winner is the
    FIRST slot with the smallest distance — what a sequential scan with a
    strict `<` keeps. A query with no finite distance gets best = +inf and
    a zero point. NaN distances never win.
    """
    nc = cx.shape[0]
    d2 = (cx - wx) ** 2 + (cy - wy) ** 2 + (cz - wz) ** 2
    d2 = jnp.where(jnp.isnan(d2), jnp.inf, d2)
    idx = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)

    def pick(a, b):
        # smaller distance wins, ties go to the lower slot: commutative and
        # associative, so XLA may reduce in any order
        a_wins = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
        return tuple(jnp.where(a_wins, u, v) for u, v in zip(a, b))

    inf = jnp.float32(jnp.inf)
    zero = jnp.float32(0.0)
    best, _, bx, by, bz = jax.lax.reduce(
        (d2, idx, cx, cy, cz), (inf, jnp.int32(nc), zero, zero, zero),
        pick, (0,),
    )
    hit = best < inf
    return (best, jnp.where(hit, bx, zero), jnp.where(hit, by, zero),
            jnp.where(hit, bz, zero))


def normal_sums(wx, wy, wz, qm, best, bx, by, bz, kth, maxd2):
    """The 18 per-query summands of one GN iteration, stacked (18, N):
    [sw, Sx, Sy, Sz, sxx, syy, szz, sxy, sxz, syz, g0..g5, ncorr, sum d2]."""
    corr = (qm > 0.5) & (best < maxd2)
    rx = jnp.where(corr, wx - bx, 0.0)
    ry = jnp.where(corr, wy - by, 0.0)
    rz = jnp.where(corr, wz - bz, 0.0)
    res2 = rx * rx + ry * ry + rz * rz
    w = jnp.where(corr, (kth * kth) / (kth + res2) ** 2, 0.0)
    sx = jnp.where(corr, wx, 0.0)
    sy = jnp.where(corr, wy, 0.0)
    sz = jnp.where(corr, wz, 0.0)
    wsx, wsy, wsz = w * sx, w * sy, w * sz
    return jnp.stack([
        w, wsx, wsy, wsz,
        wsx * sx, wsy * sy, wsz * sz, wsx * sy, wsx * sz, wsy * sz,
        w * rx, w * ry, w * rz,
        wsy * rz - wsz * ry, wsz * rx - wsx * rz, wsx * ry - wsy * rx,
        corr.astype(jnp.float32), jnp.where(corr, best, 0.0),
    ])


def gn_update(carry, sums, scal, track_m: bool):
    """Scalar half of one GN iteration: solve the Jacobi-preconditioned
    6x6 normal equations from the 18 `sums`, clamp the step, and compose
    the Rodrigues increment onto the carried (R, t). With `track_m`, also
    accumulate M = I - R_total exactly from the small Rodrigues parts
    (M @ anchor de-centers the translation without the catastrophic
    I - R cancellation at f32: entries of M are O(theta), so the relative
    error stays ~1e-7 of theta instead of ~1e-7 of 1)."""
    (r00, r01, r02, r10, r11, r12, r20, r21, r22,
     t0, t1, t2, conv, stale, ncorr_o, rms_o, iters, M) = carry
    est_th, min_corr, max_step, stale_d2 = scal[2], scal[3], scal[4], scal[5]
    active = (conv < 0.5) & (stale < 0.5)
    (sw, Sx, Sy, Sz, sxx, syy, szz, sxy, sxz, syz,
     g0, g1, g2, g3, g4, g5, ncorr, sum_d2) = [sums[i] for i in range(18)]
    rms = jnp.sqrt(sum_d2 / jnp.maximum(ncorr, 1.0))

    # Jacobi preconditioning with s = RMS coordinate magnitude:
    # solve (D A D) y = D b, xi = D y with D = diag(1,1,1,1/s,1/s,1/s)
    s2 = (sxx + syy + szz) / jnp.maximum(sw, 1e-20)
    inv_s = jax.lax.rsqrt(jnp.maximum(s2, 1e-12))
    z = sw * 0.0  # traced zero

    # B = -hat([Sx,Sy,Sz]); D = tr(ss) I - ss
    A = [
        [sw, z, z, z, Sz * inv_s, -Sy * inv_s],
        [z, sw, z, -Sz * inv_s, z, Sx * inv_s],
        [z, z, sw, Sy * inv_s, -Sx * inv_s, z],
        [z, -Sz * inv_s, Sy * inv_s,
         (syy + szz) * inv_s * inv_s, -sxy * inv_s * inv_s,
         -sxz * inv_s * inv_s],
        [Sz * inv_s, z, -Sx * inv_s,
         -sxy * inv_s * inv_s, (sxx + szz) * inv_s * inv_s,
         -syz * inv_s * inv_s],
        [-Sy * inv_s, Sx * inv_s, z,
         -sxz * inv_s * inv_s, -syz * inv_s * inv_s,
         (sxx + syy) * inv_s * inv_s],
    ]
    b = [-g0, -g1, -g2, -g3 * inv_s, -g4 * inv_s, -g5 * inv_s]

    dmax = jnp.maximum(jnp.maximum(A[0][0], A[3][3]),
                       jnp.maximum(A[4][4], A[5][5]))
    ridge = 1e-6 * jnp.maximum(dmax, 1e-12)
    L = [[None] * 6 for _ in range(6)]
    for jj in range(6):
        d = A[jj][jj] + ridge
        for kk in range(jj):
            d = d - L[jj][kk] * L[jj][kk]
        L[jj][jj] = jnp.sqrt(jnp.maximum(d, 1e-25))
        inv = 1.0 / L[jj][jj]
        for ii in range(jj + 1, 6):
            acc = A[ii][jj]
            for kk in range(jj):
                acc = acc - L[ii][kk] * L[jj][kk]
            L[ii][jj] = acc * inv
    y = [None] * 6
    for ii in range(6):
        acc = b[ii]
        for kk in range(ii):
            acc = acc - L[ii][kk] * y[kk]
        y[ii] = acc / L[ii][ii]
    xi = [None] * 6
    for ii in reversed(range(6)):
        acc = y[ii]
        for kk in range(ii + 1, 6):
            acc = acc - L[kk][ii] * xi[kk]
        xi[ii] = acc / L[ii][ii]
    vx, vy, vz = xi[0], xi[1], xi[2]
    ox, oy, oz = xi[3] * inv_s, xi[4] * inv_s, xi[5] * inv_s

    ok = ncorr >= min_corr
    step = jnp.sqrt(vx * vx + vy * vy + vz * vz
                    + ox * ox + oy * oy + oz * oz)
    clamp = jnp.where(
        step > max_step, max_step / jnp.maximum(step, 1e-20), 1.0
    )
    upd = active & ok
    scale = jnp.where(upd, clamp, 0.0)
    vx, vy, vz = vx * scale, vy * scale, vz * scale
    ox, oy, oz = ox * scale, oy * scale, oz * scale

    # Rodrigues R = I + a W + b2 W^2 and left Jacobian V (scalar f32)
    sq = ox * ox + oy * oy + oz * oz
    th = jnp.sqrt(jnp.maximum(sq, 1e-30))
    small = sq < 1e-12
    safe_sq = jnp.maximum(sq, 1e-30)
    a = jnp.where(small, 1.0 - sq / 6.0, jnp.sin(th) / th)
    b2 = jnp.where(small, 0.5 - sq / 24.0, (1.0 - jnp.cos(th)) / safe_sq)
    c3 = jnp.where(small, 1.0 / 6.0, (1.0 - a) / safe_sq)
    e00 = 1.0 + b2 * (ox * ox - sq)
    e01 = a * -oz + b2 * ox * oy
    e02 = a * oy + b2 * ox * oz
    e10 = a * oz + b2 * ox * oy
    e11 = 1.0 + b2 * (oy * oy - sq)
    e12 = a * -ox + b2 * oy * oz
    e20 = a * -oy + b2 * ox * oz
    e21 = a * ox + b2 * oy * oz
    e22 = 1.0 + b2 * (oz * oz - sq)
    v00 = 1.0 + c3 * (ox * ox - sq)
    v01 = b2 * -oz + c3 * ox * oy
    v02 = b2 * oy + c3 * ox * oz
    v10 = b2 * oz + c3 * ox * oy
    v11 = 1.0 + c3 * (oy * oy - sq)
    v12 = b2 * -ox + c3 * oy * oz
    v20 = b2 * -oy + c3 * ox * oz
    v21 = b2 * ox + c3 * oy * oz
    v22 = 1.0 + c3 * (oz * oz - sq)
    dt0 = v00 * vx + v01 * vy + v02 * vz
    dt1 = v10 * vx + v11 * vy + v12 * vz
    dt2 = v20 * vx + v21 * vy + v22 * vz

    n00 = e00 * r00 + e01 * r10 + e02 * r20
    n01 = e00 * r01 + e01 * r11 + e02 * r21
    n02 = e00 * r02 + e01 * r12 + e02 * r22
    n10 = e10 * r00 + e11 * r10 + e12 * r20
    n11 = e10 * r01 + e11 * r11 + e12 * r21
    n12 = e10 * r02 + e11 * r12 + e12 * r22
    n20 = e20 * r00 + e21 * r10 + e22 * r20
    n21 = e20 * r01 + e21 * r11 + e22 * r21
    n22 = e20 * r02 + e21 * r12 + e22 * r22
    m0 = e00 * t0 + e01 * t1 + e02 * t2 + dt0
    m1 = e10 * t0 + e11 * t1 + e12 * t2 + dt1
    m2 = e20 * t0 + e21 * t1 + e22 * t2 + dt2

    if track_m:
        # M' = M + D @ R_prev with D = I - E = -(a W + b2 W^2); the
        # diagonal 1 - e_ii is exact by Sterbenz (e_ii near 1), the
        # off-diagonals are the small Rodrigues terms directly
        d00, d11, d22 = 1.0 - e00, 1.0 - e11, 1.0 - e22
        D = ((d00, -e01, -e02), (-e10, d11, -e12), (-e20, -e21, d22))
        Rp = ((r00, r01, r02), (r10, r11, r12), (r20, r21, r22))
        M = tuple(
            tuple(
                M[i][j]
                + D[i][0] * Rp[0][j] + D[i][1] * Rp[1][j]
                + D[i][2] * Rp[2][j]
                for j in range(3)
            )
            for i in range(3)
        )

    ncorr_o = jnp.where(active, ncorr, ncorr_o)
    rms_o = jnp.where(active, rms, rms_o)
    iters = iters + jnp.where(active, jnp.float32(1.0), jnp.float32(0.0))
    conv = jnp.where(
        active & ((~ok) | (jnp.minimum(step, max_step) < est_th)),
        jnp.float32(1.0), conv,
    )
    drift2 = m0 * m0 + m1 * m1 + m2 * m2
    stale = jnp.where((conv < 0.5) & (drift2 > stale_d2), jnp.float32(1.0),
                      stale)
    return (n00, n01, n02, n10, n11, n12, n20, n21, n22,
            m0, m1, m2, conv, stale, ncorr_o, rms_o, iters, M)


def _gn_iterations(n_inner, scal, q, qmask, cand, track_m: bool):
    """n_inner GN iterations. Returns the 16 output scalars [R row-major 9,
    t 3, n_corr, rms, iters, flags] as a list (flags = converged +
    2 * stale) — plus, with `track_m`, the 3x3 nested M = I - R_total."""
    kth, maxd2 = scal[0], scal[1]
    qx, qy, qz = q[0], q[1], q[2]
    cx, cy, cz = cand[0], cand[1], cand[2]
    one, zero = jnp.float32(1.0), jnp.float32(0.0)
    m_init = ((zero, zero, zero),) * 3
    carry = (one, zero, zero, zero, one, zero, zero, zero, one,  # R
             zero, zero, zero,  # t
             zero, zero, zero, zero, zero,  # conv, stale, n_corr, rms, iters
             m_init)
    for _ in range(n_inner):
        r = carry
        wx = r[0] * qx + r[1] * qy + r[2] * qz + r[9]
        wy = r[3] * qx + r[4] * qy + r[5] * qz + r[10]
        wz = r[6] * qx + r[7] * qy + r[8] * qz + r[11]
        best, bx, by, bz = nearest_candidate(wx, wy, wz, cx, cy, cz)
        # one (18, N) reduction: all sums of the iteration in one pass
        sums = jnp.sum(
            normal_sums(wx, wy, wz, qmask, best, bx, by, bz, kth, maxd2),
            axis=-1,
        )
        carry = gn_update(carry, sums, scal, track_m)
    vals = list(carry[:12]) + [carry[14], carry[15], carry[16],
                               carry[12] + 2.0 * carry[13]]
    return vals, carry[17]


def fused_gn(q, qmask, cand, scal, n_inner: int):
    """Run `n_inner` fused GN iterations (see module docstring for layouts).

    Returns (R (3,3) f32, t (3,) f32, n_corr f32, rms f32, iters f32,
             converged bool, stale bool). Batches with `jax.vmap`.
    """
    ff.check_f32("fused GN", q, qmask, cand, scal)
    vals, _ = _gn_iterations(n_inner, scal, q, qmask, cand, track_m=False)
    flags = vals[15]
    return (jnp.stack(vals[:9]).reshape(3, 3), jnp.stack(vals[9:12]),
            vals[12], vals[13], vals[14], flags % 2.0 >= 1.0, flags >= 2.0)


def compose_carry(vals, M, carry):
    """De-center the GN result and compose it with the carried world pose.

    carry (18,) f32: [R_carry row-major 9 | t_carry hi 3 | t_carry lo 3
    | anchor 3]. Queries/candidates arrived CENTERED on `anchor`; the
    carried translation rides as a float-float pair (ops/ffmath.py) so km-
    scale world positions keep ~2^-48 relative precision through the
    per-round composition (T_world = Trans(a) T_centered Trans(-a)
    followed by T_out = T_delta @ T_carry). Returns the 15 scalars
    [R_out 9 | t_out hi 3 | t_out lo 3]."""
    Rc = [[carry[0], carry[1], carry[2]],
          [carry[3], carry[4], carry[5]],
          [carry[6], carry[7], carry[8]]]
    tc_h = [carry[9], carry[10], carry[11]]
    tc_l = [carry[12], carry[13], carry[14]]
    anchor = [carry[15], carry[16], carry[17]]

    Rd = [[vals[0], vals[1], vals[2]],
          [vals[3], vals[4], vals[5]],
          [vals[6], vals[7], vals[8]]]
    # de-center: t_world_delta = t_centered + M @ anchor (M = I - R_delta)
    twd = [
        vals[9 + i]
        + M[i][0] * anchor[0] + M[i][1] * anchor[1] + M[i][2] * anchor[2]
        for i in range(3)
    ]
    # compose with the carried pose: R_out = R_d @ R_c, t_out = R_d t_c + twd
    R_out = [
        Rd[i][0] * Rc[0][j] + Rd[i][1] * Rc[1][j] + Rd[i][2] * Rc[2][j]
        for i in range(3) for j in range(3)
    ]
    rt_h, rt_l = ff.mat3_apply_ff(Rd, tc_h, tc_l)
    to_h, to_l = [], []
    for i in range(3):
        h, l = ff.add_f(rt_h[i], rt_l[i], twd[i])
        to_h.append(h)
        to_l.append(l)
    return R_out + to_h + to_l


def fused_gn_carry(q, qmask, cand, scal, carry, n_inner: int):
    """`fused_gn` followed by the outer-round pose composition
    (`compose_carry`): the whole ICP outer-round pose update.

    carry (18,) f32: [R 9, t_hi 3, t_lo 3, anchor 3] — the accumulated
    world pose and the centering anchor of this round's queries/candidates.
    Returns (R9 (9,), t_hi (3,), t_lo (3,), n_corr f32, rms f32, iters f32,
    converged bool, stale bool) with (R9, t) already composed:
    T_out = T_delta @ T_carry.
    """
    ff.check_f32("fused GN", q, qmask, cand, scal, carry)
    vals, M = _gn_iterations(n_inner, scal, q, qmask, cand, track_m=True)
    out = compose_carry(vals, M, carry)
    flags = vals[15]
    return (jnp.stack(out[:9]), jnp.stack(out[9:12]), jnp.stack(out[12:15]),
            vals[12], vals[13], vals[14], flags % 2.0 >= 1.0, flags >= 2.0)
