"""Map / pose-graph optimization backend.

The reference promises "Non-Linear optimization for optimizing the Map"
(reference README.md:2) and draws loop closure + map optimization in its RAD
workflow figure, but ships no backend code (SURVEY §1: "no backend layer").
This module provides that capability as static-shape device code:

  * pose graph over keyframes as dense static-shape arrays
    (max_keyframes nodes, max_edges SE(3) constraints with masks)
  * batched residuals/Jacobians: every edge's 6-dim residual
    r = log(T_meas^-1 (X_i^-1 X_j)) and its two 6x6 Jacobians are computed
    in one vmap (autodiff — exact, no hand-rolled sparse blocks)
  * Levenberg-Marquardt with scatter-assembled Gauss-Newton system and
    Cholesky solve (the batched-sparse-LM design of SURVEY §7 step 8)
  * proximity-based loop-closure candidate detection with ICP verification
    against keyframe clouds

Scales across chips by sharding the edge set: the per-edge Jacobian batch is
embarrassingly parallel and the H/b assembly is a psum — see
parallel/mesh.py for the mesh utilities.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie


class PoseGraph(NamedTuple):
    poses: jnp.ndarray  # (K, 4, 4) f64 current estimates
    node_mask: jnp.ndarray  # (K,)
    edge_i: jnp.ndarray  # (E,) i32
    edge_j: jnp.ndarray  # (E,) i32
    edge_meas: jnp.ndarray  # (E, 4, 4) f64 measured T_i^-1 T_j
    edge_weight: jnp.ndarray  # (E,) f64 scalar information weight
    edge_mask: jnp.ndarray  # (E,)
    num_nodes: jnp.ndarray  # () i32
    num_edges: jnp.ndarray  # () i32


def create(max_keyframes: int, max_edges: int) -> PoseGraph:
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float64), (max_keyframes, 4, 4))
    return PoseGraph(
        poses=eye.copy(),
        node_mask=jnp.zeros(max_keyframes, bool),
        edge_i=jnp.zeros(max_edges, jnp.int32),
        edge_j=jnp.zeros(max_edges, jnp.int32),
        edge_meas=jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float64), (max_edges, 4, 4)
        ).copy(),
        edge_weight=jnp.zeros(max_edges, jnp.float64),
        edge_mask=jnp.zeros(max_edges, bool),
        num_nodes=jnp.int32(0),
        num_edges=jnp.int32(0),
    )


def add_node(g: PoseGraph, pose) -> PoseGraph:
    k = g.num_nodes
    return g._replace(
        poses=g.poses.at[k].set(pose),
        node_mask=g.node_mask.at[k].set(True),
        num_nodes=k + 1,
    )


def add_edge(g: PoseGraph, i, j, meas, weight=1.0) -> PoseGraph:
    e = g.num_edges
    return g._replace(
        edge_i=g.edge_i.at[e].set(i),
        edge_j=g.edge_j.at[e].set(j),
        edge_meas=g.edge_meas.at[e].set(meas),
        edge_weight=g.edge_weight.at[e].set(weight),
        edge_mask=g.edge_mask.at[e].set(True),
        num_edges=e + 1,
    )


def add_odometry_chain(g: PoseGraph, poses, weight=1.0) -> PoseGraph:
    """Bulk-load a trajectory: nodes + consecutive relative-pose edges."""
    for idx in range(poses.shape[0]):
        g = add_node(g, poses[idx])
        if idx > 0:
            meas = lie.transform_inverse(poses[idx - 1]) @ poses[idx]
            g = add_edge(g, idx - 1, idx, meas, weight)
    return g


def from_chain(poses_np, max_keyframes: int, max_edges: int,
               weight: float = 1.0) -> PoseGraph:
    """Build a PoseGraph from a host-side (K, 4, 4) pose chain in one shot.

    Vectorized construction: the incremental add_node/add_edge path costs
    two device dispatches per keyframe;
    the online backend rebuilds the graph every optimization round, so it
    assembles the arrays in numpy and uploads once.
    """
    import numpy as np

    poses_np = np.asarray(poses_np, np.float64)
    k = poses_np.shape[0]
    assert 0 < k <= max_keyframes, k
    assert k - 1 <= max_edges

    poses = np.broadcast_to(np.eye(4), (max_keyframes, 4, 4)).copy()
    poses[:k] = poses_np
    node_mask = np.zeros(max_keyframes, bool)
    node_mask[:k] = True

    meas = np.broadcast_to(np.eye(4), (max_edges, 4, 4)).copy()
    if k > 1:
        inv_prev = np.linalg.inv(poses_np[:-1])
        meas[: k - 1] = inv_prev @ poses_np[1:]
    edge_i = np.zeros(max_edges, np.int32)
    edge_j = np.zeros(max_edges, np.int32)
    edge_i[: k - 1] = np.arange(k - 1)
    edge_j[: k - 1] = np.arange(1, k)
    edge_w = np.zeros(max_edges)
    edge_w[: k - 1] = weight
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[: k - 1] = True
    return PoseGraph(
        poses=jnp.asarray(poses),
        node_mask=jnp.asarray(node_mask),
        edge_i=jnp.asarray(edge_i),
        edge_j=jnp.asarray(edge_j),
        edge_meas=jnp.asarray(meas),
        edge_weight=jnp.asarray(edge_w),
        edge_mask=jnp.asarray(edge_mask),
        num_nodes=jnp.int32(k),
        num_edges=jnp.int32(k - 1),
    )


def _edge_residual(xi_i, xi_j, pose_i, pose_j, meas):
    """r = log(meas^-1 (X_i exp(xi_i))^-1 (X_j exp(xi_j))) — local twists."""
    Xi = pose_i @ lie.se3_exp(xi_i)
    Xj = pose_j @ lie.se3_exp(xi_j)
    return lie.se3_log(lie.transform_inverse(meas) @ lie.transform_inverse(Xi) @ Xj)


def _edge_terms(g: PoseGraph):
    """Residuals + Jacobians at the current linearization point (xi = 0)."""
    zero = jnp.zeros(6, jnp.float64)

    def one(i, j, meas, w, ok):
        pose_i, pose_j = g.poses[i], g.poses[j]
        r = _edge_residual(zero, zero, pose_i, pose_j, meas)
        Ji = jax.jacobian(_edge_residual, argnums=0)(zero, zero, pose_i, pose_j, meas)
        Jj = jax.jacobian(_edge_residual, argnums=1)(zero, zero, pose_i, pose_j, meas)
        w = jnp.where(ok, w, 0.0)
        return r * jnp.sqrt(w), Ji * jnp.sqrt(w)[..., None], Jj * jnp.sqrt(w)[..., None]

    return jax.vmap(one)(g.edge_i, g.edge_j, g.edge_meas, g.edge_weight, g.edge_mask)


def _assemble(g: PoseGraph, r, Ji, Jj, damping):
    """Scatter-add the GN normal equations H dx = -b over node blocks."""
    k = g.poses.shape[0]
    dim = 6 * k
    H = jnp.zeros((dim, dim), jnp.float64)
    b = jnp.zeros((dim,), jnp.float64)

    bi = g.edge_i * 6
    bj = g.edge_j * 6

    def blocks(J1, J2):
        return jnp.einsum("eai,eaj->eij", J1, J2)

    # per-edge 6x6 blocks
    Hii, Hjj = blocks(Ji, Ji), blocks(Jj, Jj)
    Hij = blocks(Ji, Jj)
    bi_vec = jnp.einsum("eai,ea->ei", Ji, r)
    bj_vec = jnp.einsum("eai,ea->ei", Jj, r)

    rows = jnp.arange(6)

    def scatter_block(H, base_r, base_c, blk):
        idx_r = base_r[:, None, None] + rows[None, :, None]
        idx_c = base_c[:, None, None] + rows[None, None, :]
        return H.at[idx_r, idx_c].add(blk)

    H = scatter_block(H, bi, bi, Hii)
    H = scatter_block(H, bj, bj, Hjj)
    H = scatter_block(H, bi, bj, Hij)
    H = scatter_block(H, bj, bi, jnp.swapaxes(Hij, 1, 2))
    b = b.at[(bi[:, None] + rows[None, :])].add(bi_vec)
    b = b.at[(bj[:, None] + rows[None, :])].add(bj_vec)

    # gauge fix: strong prior on node 0; inactive nodes pinned too
    active = jnp.repeat(g.node_mask, 6)
    anchor = jnp.zeros(dim, bool).at[:6].set(True)
    prior = jnp.where(anchor | ~active, 1e12, 0.0)
    H = H + jnp.diag(prior + damping + 1e-12)
    return H, b


def optimize(g: PoseGraph, iterations: int = 10, damping: float = 1e-6) -> PoseGraph:
    """Levenberg-Marquardt over the pose graph (fixed iteration count with
    monotone-accept step logic inside jit)."""

    def body(_, carry):
        g, lam = carry
        r, Ji, Jj = _edge_terms(g)
        H, b = _assemble(g, r, Ji, Jj, lam)
        L = jnp.linalg.cholesky(H)
        dx = jax.scipy.linalg.cho_solve((L, True), -b)
        dx = dx.reshape(-1, 6)
        new_poses = g.poses @ lie.se3_exp(dx)

        # accept if total error decreased; else raise damping
        def cost(poses):
            g2 = g._replace(poses=poses)
            r2, _, _ = _edge_terms(g2)
            return jnp.sum(r2 * r2)

        c_old = jnp.sum(r * r)
        c_new = cost(new_poses)
        accept = c_new < c_old
        poses = jnp.where(accept, new_poses, g.poses)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return g._replace(poses=poses), lam

    g, _ = jax.lax.fori_loop(0, iterations, body, (g, jnp.float64(damping)))
    return g


@partial(jax.jit, static_argnames=("iterations",))
def optimize_jit(g: PoseGraph, iterations: int = 10) -> PoseGraph:
    return optimize(g, iterations)


# ---------------------------------------------------------------------------
# Matrix-free PCG solver (KITTI-length graphs)
# ---------------------------------------------------------------------------
#
# The dense path above assembles the full (6K, 6K) Hessian and Cholesky-
# factors it: O(K^2) memory and O(K^3) solve — fine to ~256 keyframes,
# prohibitive for a KITTI-00-length run (round-2 VERDICT weak #5). A pose
# graph is a chain plus a few loop edges, so H is block-tridiagonal + a
# handful of off-diagonal blocks; the answer here is to never
# materialize it: apply H matrix-free from the edge list (two batched
# einsums + two segment scatter-adds per matvec, O(E) work) inside a
# block-Jacobi-preconditioned conjugate-gradient loop. Gauge fixing is by
# PROJECTION (node 0 and inactive nodes are frozen out of the Krylov
# space), not the dense path's 1e12 prior — a 1e12 diagonal would destroy
# CG's conditioning.


def _apply_H(g: PoseGraph, Ji, Jj, free, lam, x):
    """y = (J^T J + lam I) x restricted to free nodes; x, y: (K, 6) f64.

    Ji/Jj carry sqrt(edge weight) (see _edge_terms), so masked edges
    (weight 0) contribute nothing; their index-0 edge_i/edge_j scatter
    targets receive zeros."""
    x = jnp.where(free[:, None], x, 0.0)
    ax = jnp.einsum("eai,ei->ea", Ji, x[g.edge_i]) + jnp.einsum(
        "eai,ei->ea", Jj, x[g.edge_j]
    )
    y = (
        jnp.zeros_like(x)
        .at[g.edge_i]
        .add(jnp.einsum("eai,ea->ei", Ji, ax))
        .at[g.edge_j]
        .add(jnp.einsum("eai,ea->ei", Jj, ax))
    )
    return jnp.where(free[:, None], y + lam * x, 0.0)


def _block_jacobi_inv(g: PoseGraph, Ji, Jj, free, lam):
    """Inverse 6x6 diagonal blocks of (J^T J + lam I): (K, 6, 6) f64.
    Unrolled Cholesky (lie.chol_solve_unrolled) — no XLA while-loop
    lowering, vmaps cleanly over nodes."""
    k = g.poses.shape[0]
    Hii = jnp.einsum("eai,eaj->eij", Ji, Ji)
    Hjj = jnp.einsum("eai,eaj->eij", Jj, Jj)
    diag = (
        jnp.zeros((k, 6, 6), jnp.float64)
        .at[g.edge_i]
        .add(Hii)
        .at[g.edge_j]
        .add(Hjj)
    )
    eye6 = jnp.eye(6, dtype=jnp.float64)
    diag = diag + (lam + 1e-9) * eye6[None]
    # frozen nodes get identity blocks (their residual lanes are zero)
    diag = jnp.where(free[:, None, None], diag, eye6[None])
    return jax.vmap(lambda A: lie.chol_solve_unrolled(A, eye6))(diag)


def _pcg(g: PoseGraph, Ji, Jj, free, lam, b, n_iters: int):
    """Block-Jacobi PCG for (J^T J + lam I) dx = b on the free nodes."""
    Minv = _block_jacobi_inv(g, Ji, Jj, free, lam)
    b = jnp.where(free[:, None], b, 0.0)

    def prec(r):
        return jnp.einsum("kij,kj->ki", Minv, r)

    def dot(a, c):
        return jnp.sum(a * c)

    x0 = jnp.zeros_like(b)
    r0 = b  # x0 = 0
    z0 = prec(r0)
    rz0 = dot(r0, z0)

    def body(_, carry):
        x, r, p, rz = carry
        Hp = _apply_H(g, Ji, Jj, free, lam, p)
        denom = dot(p, Hp)
        alpha = jnp.where(denom > 0, rz / jnp.maximum(denom, 1e-300), 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = prec(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-300), 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (x0, r0, z0, rz0))
    return x


def optimize_cg(
    g: PoseGraph, iterations: int = 10, cg_iterations: int = 64,
    damping: float = 1e-6,
) -> PoseGraph:
    """Levenberg-Marquardt with the matrix-free PCG inner solve. Same
    monotone-accept logic as `optimize`; O(E * cg_iterations) per LM step
    and O(K) memory instead of O(K^3)/O(K^2)."""
    free = g.node_mask & (jnp.arange(g.poses.shape[0]) != 0)

    def body(_, carry):
        g, lam = carry
        r, Ji, Jj = _edge_terms(g)
        b = -(
            jnp.zeros((g.poses.shape[0], 6), jnp.float64)
            .at[g.edge_i]
            .add(jnp.einsum("eai,ea->ei", Ji, r))
            .at[g.edge_j]
            .add(jnp.einsum("eai,ea->ei", Jj, r))
        )
        dx = _pcg(g, Ji, Jj, free, lam, b, cg_iterations)
        new_poses = g.poses @ lie.se3_exp(dx)

        def cost(poses):
            r2, _, _ = _edge_terms(g._replace(poses=poses))
            return jnp.sum(r2 * r2)

        c_old = jnp.sum(r * r)
        accept = cost(new_poses) < c_old
        poses = jnp.where(accept, new_poses, g.poses)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return g._replace(poses=poses), lam

    g, _ = jax.lax.fori_loop(0, iterations, body, (g, jnp.float64(damping)))
    return g


@partial(jax.jit, static_argnames=("iterations", "cg_iterations"))
def optimize_cg_jit(
    g: PoseGraph, iterations: int = 10, cg_iterations: int = 64
) -> PoseGraph:
    return optimize_cg(g, iterations, cg_iterations)


def graph_error(g: PoseGraph) -> jnp.ndarray:
    r, _, _ = _edge_terms(g)
    return jnp.sum(r * r)


# ---------------------------------------------------------------------------
# Loop closure
# ---------------------------------------------------------------------------


class LoopCandidates(NamedTuple):
    idx_i: jnp.ndarray  # (C,) i32
    idx_j: jnp.ndarray  # (C,) i32
    dist: jnp.ndarray  # (C,) f64
    mask: jnp.ndarray  # (C,)


def find_loop_candidates(
    g: PoseGraph, radius: float, min_index_gap: int, max_candidates: int
) -> LoopCandidates:
    """Proximity candidates: node pairs whose positions re-approach after a
    long index gap — the 'revisit' signature. Dense (K, K) masked distance
    matrix, top-C by closeness."""
    t = g.poses[:, :3, 3]
    d = jnp.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
    k = t.shape[0]
    ii = jnp.arange(k)[:, None]
    jj = jnp.arange(k)[None, :]
    valid = (
        g.node_mask[:, None]
        & g.node_mask[None, :]
        & ((jj - ii) > min_index_gap)
        & (d < radius)
    )
    score = jnp.where(valid, d, jnp.inf).reshape(-1)
    order = jnp.argsort(score)[:max_candidates]
    return LoopCandidates(
        idx_i=(order // k).astype(jnp.int32),
        idx_j=(order % k).astype(jnp.int32),
        dist=score[order],
        mask=jnp.isfinite(score[order]),
    )


def verify_and_add_loops(
    g: PoseGraph,
    candidates: LoopCandidates,
    keyframe_clouds,  # (K, N, 3) f32 stored keyframe source clouds
    keyframe_cloud_masks,  # (K, N)
    map_cfg,
    max_corresp_dist: float = 1.0,
    max_residual: float = 0.3,
    weight: float = 1.0,
):
    """ICP-verify each candidate pair (register cloud_j against a temp map
    of cloud_i in i's frame); accept if converged with small residual.

    Host-driven loop (candidates are few); each verification is a jitted
    ICP. Returns the graph with accepted loop edges added.
    """
    import numpy as np

    from ..ops import icp as icp_ops
    from ..ops import voxel_map

    for c in range(int(np.asarray(candidates.mask).sum())):
        i = int(candidates.idx_i[c])
        j = int(candidates.idx_j[c])
        cloud_i = keyframe_clouds[i]
        cloud_j = keyframe_clouds[j]
        m = voxel_map.create(map_cfg)
        m = voxel_map.insert(m, cloud_i, keyframe_cloud_masks[i], map_cfg)
        guess = lie.transform_inverse(g.poses[i]) @ g.poses[j]
        res = icp_ops.icp_registration(
            m, cloud_j, keyframe_cloud_masks[j], guess,
            max_corresp_dist, max_corresp_dist / 3.0, map_cfg, 30, 1e-5,
        )
        if float(res.residual_rms) < max_residual and int(res.num_correspondences) > 50:
            g = add_edge(g, i, j, res.pose, weight)
    return g
