"""Per-scan pose bookkeeping of the fast KISS-ICP step as two scalar chains.

The KISS-ICP step's scalar pose math — motion prediction, initial guess,
has-moved gate, adaptive-threshold update, deskew twist, divergence gate,
orthonormalization, map-correction delta (reference icp.cpp:36-86 +
threshold.cpp) — is a ~70-op chain of 4x4 scalar algebra. Here it runs
in f32 + float-float as two plain `jnp` chains, one before ICP
(`pose_pre`) and one after (`pose_post`); the f64 state crosses into
them once per scan. XLA fuses each chain into a few loop kernels.

Precision: rotations are f32 (entries O(1); the per-scan orthonormalization
keeps the defect at f32 eps, and per-scan numeric rotation noise ~1e-7 rad
sits 3 orders of magnitude below the ICP estimation noise). Translations —
which grow to km scale while per-scan increments stay at mm scale — are
carried as float-float (hi, lo) pairs (ops/ffmath.py, ~2^-48
relative). Documented deviation from the all-f64 reference (PARITY.md).

These chains serve the UNBATCHED while-loop path only: batched configs
(batch_unroll_outer > 0) keep the classic f64 chain, vectorized across
streams.

Layouts (all f32 unless noted):
  pose_pre inputs:
    hi/lo (49,): [pose 16 | pose_prev 16 | first_pose 16 | thr_sse 1]
      (4x4 row-major; hi/lo = float-float split of the f64 state)
    md (16,): threshold model_deviation (f32 — small values)
    ints (2,) i32: [num_poses, thr_num_samples]
  pose_pre output row (33,):
    [0:9]   guess R        [9:12]  guess t hi   [12:15] guess t lo
    [15]    sigma          [16]    moved        [17] thr_sse' hi
    [18]    thr_n'         [19]    |w| (deskew) [20:23] k
    [23:26] v              [26:29] w x v        [29:32] w x (w x v)
    [32]    thr_sse' lo
  pose_post input:
    a (30,): [icp correction R 9 | corr t hi 3 | corr t lo 3 |
              guess R 9 | guess t hi 3 | guess t lo 3]
    (the registration runs on world-frame source from identity, so its
    result is the correction; the chain composes corr @ guess itself)
  pose_post output row (44,):
    [0:9]   new_pose R (orthonormalized)  [9:12] t hi  [12:15] t lo
    [15]    diverged      [16:25] delta R  [25:28] delta t
    [28:44] model_deviation' (4x4 row-major)
"""

from __future__ import annotations

import jax.numpy as jnp

from . import ffmath as ff


def _mat3(read, base, idx=(0, 1, 2, 4, 5, 6, 8, 9, 10)):
    """Read a row-major (4,4) transform's rotation block as a 3x3 nested
    list of scalars. `read(i)` loads element i of the 16-wide pose."""
    e = [read(base + i) for i in idx]
    return [[e[0], e[1], e[2]], [e[3], e[4], e[5]], [e[6], e[7], e[8]]]


def _matmul3(A, B):
    return [
        [sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]


def _transpose3(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def _mat3_vec(A, v):
    return [A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2] for i in range(3)]


def _cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _sel3x3(p, A, B):
    return [[jnp.where(p, A[i][j], B[i][j]) for j in range(3)] for i in range(3)]


def _sel3(p, a, b):
    return [jnp.where(p, a[i], b[i]) for i in range(3)]


_I3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _axis_angle(R):
    """(s_vec = sin(th)*axis, sin_th, cos_th, th) of a 3x3 rotation.

    th via ffmath.atan2_pos — exact to f32 eps for th <= ~2.5 rad, which
    per-scan relative rotations never approach (the divergence gate and
    physics bound them)."""
    sx = 0.5 * (R[2][1] - R[1][2])
    sy = 0.5 * (R[0][2] - R[2][0])
    sz = 0.5 * (R[1][0] - R[0][1])
    c = jnp.clip(0.5 * (R[0][0] + R[1][1] + R[2][2] - 1.0), -1.0, 1.0)
    sn2 = sx * sx + sy * sy + sz * sz
    sn = jnp.sqrt(jnp.maximum(sn2, 0.0))
    th = ff.atan2_pos(sn, c)
    return [sx, sy, sz], sn, c, th


def pose_pre(hi, lo, md, ints, *, min_motion_th: float,
             initial_threshold: float, max_range: float, deskew_on: bool):
    """Run the pre-ICP bookkeeping chain. Returns the (33,) f32 row (see
    module docstring for slots)."""
    ff.check_f32("pose chain", hi, lo, md)
    np_ = ints[0]
    thr_n = ints[1]

    def rh(i):
        return hi[i]

    R_cur = _mat3(rh, 0)
    R_prev = _mat3(rh, 16)
    R_first = _mat3(rh, 32)
    t_idx = (3, 7, 11)
    tc_h = [hi[i] for i in t_idx]
    tc_l = [lo[i] for i in t_idx]
    tp_h = [hi[16 + i] for i in t_idx]
    tp_l = [lo[16 + i] for i in t_idx]
    tf_h = [hi[32 + i] for i in t_idx]
    tf_l = [lo[32 + i] for i in t_idx]

    # relative pose rel = pose_prev^-1 @ pose: R_rel = Rp^T Rc,
    # t_rel = Rp^T (t - t_p) — the ff subtraction preserves the small
    # relative translation exactly at km-scale absolute positions
    R_rel = _matmul3(_transpose3(R_prev), R_cur)
    d = [ff.sub(tc_h[i], tc_l[i], tp_h[i], tp_l[i])[0] for i in range(3)]
    t_rel = _mat3_vec(_transpose3(R_prev), d)

    # constant-velocity prediction + guess (reference icp.cpp:146-154):
    # pred = rel (identity below 2 poses); guess = last_pose @ pred
    has2 = np_ >= 2
    R_pred = _sel3x3(has2, R_rel, _I3)
    t_pred = _sel3(has2, t_rel, (0.0, 0.0, 0.0))
    has1 = np_ >= 1
    R_last = _sel3x3(has1, R_cur, _I3)
    R_g = _matmul3(R_last, R_pred)
    rt = _mat3_vec(R_last, t_pred)
    tg_h, tg_l = [], []
    for i in range(3):
        h, l = ff.add_f(
            jnp.where(has1, tc_h[i], 0.0), jnp.where(has1, tc_l[i], 0.0),
            rt[i],
        )
        tg_h.append(h)
        tg_l.append(l)

    # has_moved (reference icp.cpp:156-163): ||(first^-1 last).t||
    df = [ff.sub(tc_h[i], tc_l[i], tf_h[i], tf_l[i])[0] for i in range(3)]
    mrel = _mat3_vec(_transpose3(R_first), df)
    m2 = mrel[0] * mrel[0] + mrel[1] * mrel[1] + mrel[2] * mrel[2]
    mth = jnp.float32(5.0 * min_motion_th)
    moved = (np_ >= 1) & (m2 > mth * mth)

    # adaptive threshold (reference threshold.cpp:5-29): model error
    # 2*r*sin(th/2) + ||t|| of the stored deviation; sin(th/2) comes
    # straight from cos(th) — no angle extraction needed
    R_md = _mat3(lambda i: md[i], 0)
    c_md = jnp.clip(
        0.5 * (R_md[0][0] + R_md[1][1] + R_md[2][2] - 1.0), -1.0, 1.0
    )
    sin_half = jnp.sqrt(jnp.maximum(0.5 * (1.0 - c_md), 0.0))
    t_md2 = md[3] ** 2 + md[7] ** 2 + md[11] ** 2
    err = 2.0 * jnp.float32(max_range) * sin_half + jnp.sqrt(t_md2)
    acc = moved & (err > jnp.float32(min_motion_th))
    sse_h, sse_l = ff.add_f(
        hi[48], lo[48], jnp.where(acc, err * err, 0.0)
    )
    n_new = thr_n + jnp.where(acc, 1, 0)
    sigma_ad = jnp.sqrt(sse_h / jnp.maximum(n_new, 1).astype(jnp.float32))
    sigma = jnp.where(
        moved & (n_new >= 1), sigma_ad, jnp.float32(initial_threshold)
    )

    # deskew twist xi = log(rel) (reference deskew.cpp:10-29 feed): emitted
    # as the scalar pieces `ops.deskew.deskew_from_scalars` consumes; all
    # zero when gated (num_poses <= 2 or deskew off) — the vector deskew
    # then reduces to identity with no lax.cond
    if deskew_on:
        s_vec, sn, c, th = _axis_angle(R_rel)
        small = sn < 1e-6
        scale = jnp.where(small, 1.0 + sn * sn / 6.0,
                          th / jnp.where(small, 1.0, sn))
        w = [s_vec[i] * scale for i in range(3)]
        th2 = th * th
        half = 0.5 * th
        s2 = jnp.sin(half)
        c2 = jnp.cos(half)
        coeff = jnp.where(
            small,
            1.0 / 12.0 + th2 / 720.0,
            (1.0 - half * c2 / jnp.where(small, 1.0, s2))
            / jnp.where(small, 1.0, th2),
        )
        wt = _cross(w, t_rel)
        wwt = _cross(w, wt)
        v = [t_rel[i] - 0.5 * wt[i] + coeff * wwt[i] for i in range(3)]
        g = ((np_ > 2) & (sn > 0)).astype(jnp.float32)
        kx = [jnp.where(small, 0.0, s_vec[i] / jnp.where(small, 1.0, sn)) * g
              for i in range(3)]
        wn_o = th * g
        v = [v[i] * g for i in range(3)]
        wg = [w[i] * g for i in range(3)]
        wxv = _cross(wg, v)
        wwxv = _cross(wg, wxv)
    else:
        z = jnp.float32(0.0)
        wn_o = z
        kx = [z, z, z]
        v = [z, z, z]
        wxv = [z, z, z]
        wwxv = [z, z, z]

    return jnp.stack([R_g[0][0], R_g[0][1], R_g[0][2],
                      R_g[1][0], R_g[1][1], R_g[1][2],
                      R_g[2][0], R_g[2][1], R_g[2][2],
                      tg_h[0], tg_h[1], tg_h[2], tg_l[0], tg_l[1], tg_l[2],
                      sigma, moved.astype(jnp.float32), sse_h,
                      n_new.astype(jnp.float32), wn_o,
                      kx[0], kx[1], kx[2], v[0], v[1], v[2],
                      wxv[0], wxv[1], wxv[2], wwxv[0], wwxv[1], wwxv[2], sse_l])


def pose_post(a, *, max_model_deviation: float):
    """Run the post-ICP bookkeeping chain. `a` is the (30,) f32 input
    vector; returns the (44,) f32 row (see module docstring)."""
    ff.check_f32("pose chain", a)
    R_c = _mat3(lambda i: a[i], 0, idx=tuple(range(9)))
    tc_h = [a[9 + i] for i in range(3)]
    tc_l = [a[12 + i] for i in range(3)]
    R_g = _mat3(lambda i: a[i], 15, idx=tuple(range(9)))
    tg_h = [a[24 + i] for i in range(3)]
    tg_l = [a[27 + i] for i in range(3)]

    # pose_icp = correction @ guess (the registration ran on world-frame
    # source from identity — reference registration.cpp:94-130 semantics,
    # classic path's lie.compose(result.pose, init_guess))
    R_icp = _matmul3(R_c, R_g)
    rg_h, rg_l = ff.mat3_apply_ff(R_c, tg_h, tg_l)
    ti_h, ti_l = [], []
    for i in range(3):
        h, l = ff.add(rg_h[i], rg_l[i], tc_h[i], tc_l[i])
        ti_h.append(h)
        ti_l.append(l)

    # model deviation = guess^-1 @ pose_icp (reference icp.cpp:78-79)
    R_dev = _matmul3(_transpose3(R_g), R_icp)
    dt = [ff.sub(ti_h[i], ti_l[i], tg_h[i], tg_l[i])[0] for i in range(3)]
    t_dev = _mat3_vec(_transpose3(R_g), dt)

    # scan-level divergence gate (no reference equivalent — documented):
    # fall back to the motion prediction on a wild registration
    mmd = jnp.float32(max_model_deviation)
    div = (t_dev[0] ** 2 + t_dev[1] ** 2 + t_dev[2] ** 2) > mmd * mmd
    R_s = _sel3x3(div, R_g, R_icp)
    ts_h = _sel3(div, tg_h, ti_h)
    ts_l = _sel3(div, tg_l, ti_l)

    # one Newton orthonormalization step R(1.5 I - 0.5 R^T R): quadratic
    # defect reduction, floors at f32 eps each scan (replaces the f64
    # quaternion round-trip of lie.orthonormalize on this path)
    E = _matmul3(_transpose3(R_s), R_s)
    C = [[(1.5 if i == j else 0.0) - 0.5 * E[i][j] for j in range(3)]
         for i in range(3)]
    R_o = _matmul3(R_s, C)

    # map-correction delta = new_pose @ guess^-1 (reference icp.cpp:81 —
    # the insert applies only the ICP correction to world-frame points):
    # t_d = t_new - R_d @ t_g needs ff (two large translations cancel)
    R_d = _matmul3(R_o, _transpose3(R_g))
    rdg_h, rdg_l = ff.mat3_apply_ff(R_d, tg_h, tg_l)
    t_d = [
        ff.sub(ts_h[i], ts_l[i], rdg_h[i], rdg_l[i])[0] for i in range(3)
    ]

    zero = jnp.float32(0.0)
    one = jnp.float32(1.0)

    def devsel(i, j):
        return jnp.where(div, one if i == j else zero, R_dev[i][j])

    return jnp.stack(
        [R_o[0][0], R_o[0][1], R_o[0][2],
         R_o[1][0], R_o[1][1], R_o[1][2],
         R_o[2][0], R_o[2][1], R_o[2][2],
         ts_h[0], ts_h[1], ts_h[2], ts_l[0], ts_l[1], ts_l[2],
         div.astype(jnp.float32),
         R_d[0][0], R_d[0][1], R_d[0][2],
         R_d[1][0], R_d[1][1], R_d[1][2],
         R_d[2][0], R_d[2][1], R_d[2][2],
         t_d[0], t_d[1], t_d[2],
         # model_deviation' as a row-major 4x4 (identity when diverged)
         devsel(0, 0), devsel(0, 1), devsel(0, 2),
         jnp.where(div, zero, t_dev[0]),
         devsel(1, 0), devsel(1, 1), devsel(1, 2),
         jnp.where(div, zero, t_dev[1]),
         devsel(2, 0), devsel(2, 1), devsel(2, 2),
         jnp.where(div, zero, t_dev[2]),
         zero, zero, zero, one]
    )
