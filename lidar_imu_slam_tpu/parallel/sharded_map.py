"""Map-parallel odometry: ONE SLAM stream whose voxel map is sharded across
the device mesh.

The stream-parallel path (`parallel/streams.py` + `parallel/mesh.py`) scales
independent streams; this module scales a SINGLE stream's map beyond one
device's memory (SURVEY §5 "long-context analog": shard the map if a single
scan's map exceeds one device) — BASELINE config 3's long-sequence maps.

Design (no reference counterpart — the reference is single
host):

  * every device owns an independent sub-table of `cfg.capacity` slots;
    voxel keys are assigned to shards by a salted hash, so total capacity
    scales as D x capacity with windows never crossing shard boundaries.
  * queries are replicated; each shard reduces its own candidates to a
    per-shard NN, and the cross-shard argmin is a tiny (D, N, 4) reduction
    that GSPMD lowers to a collective.
  * inserts are replicated work, masked to the owning shard (a group's
    members follow their head key's owner); eviction/rebuild are local.

With zero hash drops the sharded pipeline is numerically IDENTICAL to the
single-map pipeline at D x capacity: per-voxel content (first-K wins) and NN
winners are the same points (`tests/test_sharded_map.py` asserts pose-level
agreement).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..models import kiss_icp
from ..ops import icp as icp_ops
from ..ops import lie, stats, voxel_map


class ShardedKissState(NamedTuple):
    map: voxel_map.VoxelMap  # leaves with leading (D, ...) shard axis
    pose: jnp.ndarray
    pose_prev: jnp.ndarray
    first_pose: jnp.ndarray
    num_poses: jnp.ndarray
    threshold: icp_ops.ThresholdState


def init_state(cfg: PipelineConfig, n_shards: int) -> ShardedKissState:
    one = voxel_map.create(cfg.map)
    smap = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_shards,) + x.shape).copy(), one
    )
    return ShardedKissState(
        map=smap,
        pose=jnp.eye(4, dtype=jnp.float64),
        pose_prev=jnp.eye(4, dtype=jnp.float64),
        first_pose=jnp.eye(4, dtype=jnp.float64),
        num_poses=jnp.int32(0),
        threshold=icp_ops.threshold_init(),
    )


def shard_state(state: ShardedKissState, mesh, axis: str = "mp") -> ShardedKissState:
    """Place the map's shard axis on the mesh; the rest replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    smap = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(axis))), state.map
    )
    rest = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())),
        state._replace(map=None)._asdict(),
    )
    return ShardedKissState(map=smap, **{k: v for k, v in rest.items() if k != "map"})


def _owner(keys: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Shard assignment by a salted hash — independent bits from the
    in-table bucket hash so shard load stays uniform."""
    k = keys.astype(jnp.uint32) ^ jnp.uint32(0x9E3779B9)
    k = (k ^ (k >> jnp.uint32(15))) * jnp.uint32(0x2C1B3C6D)
    k = (k ^ (k >> jnp.uint32(12))) * jnp.uint32(0x297A2D39)
    k = k ^ (k >> jnp.uint32(15))
    return (k % jnp.uint32(n_shards)).astype(jnp.int32)


def _sharded_fetch(smap, queries_f32, qmask, cfg):
    """Per-shard candidate gather (once per outer round): (D, N, NB*K)
    de-interleaved planes, sharded over the mesh with the map."""
    def one_shard(m):
        cand, cand_valid = voxel_map.gather_candidates(
            m, queries_f32, qmask, cfg.map
        )
        cx, cy, cz = voxel_map.deinterleave_candidates(cand)
        return cx, cy, cz, cand_valid

    return jax.vmap(one_shard)(smap)


def _sharded_nn_from_candidates(planes, qx, qy, qz, qmask):
    """Per-shard reduce over cached candidates + cross-shard argmin: the
    only cross-device traffic is the (D, N, 4) winner exchange, which GSPMD
    lowers to a collective. Returns SoA winners."""
    cx, cy, cz, cand_valid = planes

    def one(cx, cy, cz, cand_valid):
        return voxel_map.nn_from_candidates_soa(
            cx, cy, cz, cand_valid, qx, qy, qz, qmask
        )

    tx, ty, tz, d2, found = jax.vmap(one)(cx, cy, cz, cand_valid)  # (D, N)
    best = jnp.argmin(d2, axis=0)
    lanes = jnp.arange(d2.shape[1])
    sel = lambda a: a[best, lanes]  # noqa: E731
    return sel(tx), sel(ty), sel(tz), sel(d2), found.any(axis=0)


def _icp_sharded(smap, source, source_mask, max_corresp_dist, kernel_th,
                 cfg: PipelineConfig, n_outer: int, n_inner: int):
    """Fixed-unroll GN-ICP against the sharded map: the same fetch-per-
    outer-round schedule and per-iteration math as
    icp_registration_unrolled, with the sharded NN backend — with zero hash
    drops the winners are the same points, so poses match the single-map
    path."""
    max_d2 = max_corresp_dist * max_corresp_dist
    px = source[:, 0].astype(jnp.float64)
    py = source[:, 1].astype(jnp.float64)
    pz = source[:, 2].astype(jnp.float64)
    eye = jnp.eye(4, dtype=jnp.float64)

    T_icp = eye
    converged = jnp.asarray(False)
    n_corr = jnp.int32(0)
    iters = jnp.int32(0)

    for _ in range(n_outer):
        fx, fy, fz = icp_ops._transform_soa(T_icp, px, py, pz)
        qf = jnp.stack(
            [fx.astype(jnp.float32), fy.astype(jnp.float32),
             fz.astype(jnp.float32)], axis=-1,
        )
        planes = _sharded_fetch(smap, qf, source_mask, cfg)
        for _ in range(n_inner):
            wx, wy, wz = icp_ops._transform_soa(T_icp, px, py, pz)
            tx, ty, tz, d2, found = _sharded_nn_from_candidates(
                planes, wx.astype(jnp.float32), wy.astype(jnp.float32),
                wz.astype(jnp.float32), source_mask,
            )
            corr = found & (d2 < max_d2)
            estimate, xi = icp_ops._align_soa(
                wx, wy, wz, tx.astype(jnp.float64), ty.astype(jnp.float64),
                tz.astype(jnp.float64), corr, kernel_th,
            )
            nc = jnp.sum(corr, dtype=jnp.int32)
            step = jnp.linalg.norm(xi)
            ok = nc >= cfg.icp.min_correspondences
            scale = jnp.where(
                step > cfg.icp.max_step_norm, cfg.icp.max_step_norm / step, 1.0
            )
            estimate = jnp.where(
                ok,
                jnp.where(scale < 1.0, lie.se3_exp_poly(xi * scale), estimate),
                eye,
            )
            active = ~converged
            T_icp = jnp.where(active, lie.compose(estimate, T_icp), T_icp)
            n_corr = jnp.where(active, nc, n_corr)
            iters = iters + active.astype(jnp.int32)
            converged = converged | (~ok) | (
                jnp.minimum(step, cfg.icp.max_step_norm)
                < cfg.icp.estimation_threshold
            )

    empty = jnp.sum(jax.vmap(voxel_map.num_voxels)(smap)) == 0
    pose = jnp.where(empty, eye, T_icp)
    return pose, iters, n_corr


def register_frame(state: ShardedKissState, scan, cfg: PipelineConfig,
                   n_shards: int, n_outer: int = 2, n_inner: int = 4):
    """Map-sharded analog of kiss_icp.register_frame (same flow; sharded NN
    backend and owner-masked insert)."""
    last_pose = jnp.where(
        state.num_poses == 0, jnp.eye(4, dtype=jnp.float64), state.pose
    )
    pred = lie.compose(lie.transform_inverse(state.pose_prev), state.pose)
    pred = jnp.where(state.num_poses < 2, jnp.eye(4, dtype=jnp.float64), pred)
    init_guess = lie.compose(last_pose, pred)

    Rg = init_guess[:3, :3].astype(jnp.float32)
    tg = init_guess[:3, 3].astype(jnp.float32)
    world = lie.rotate_points(Rg, scan.xyz) + tg
    g = voxel_map.fused_downsample(
        world, scan.mask, cfg.map.voxel_size, cfg.icp.max_map_points
    )
    source, source_mask, _, src_drops = voxel_map.first_point_per_voxel(
        g.points, g.mask, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points
    )
    d_sq = jnp.sum((source - tg[None, :]) ** 2, axis=-1)
    source_mask = stats.iqr_inlier_mask(d_sq.astype(jnp.float64), source_mask)

    moved = kiss_icp.has_moved(
        kiss_icp.KissState(None, state.pose, state.pose_prev,
                           state.first_pose, state.num_poses, state.threshold),
        cfg.icp.min_motion_th,
    )
    thr_state, sigma = icp_ops.compute_threshold(
        state.threshold, moved, cfg.icp.initial_threshold,
        cfg.icp.min_motion_th, cfg.map.max_range,
    )

    T_icp, iters, n_corr = _icp_sharded(
        state.map, source, source_mask, 3.0 * sigma, sigma / 3.0, cfg,
        n_outer, n_inner,
    )
    pose_icp = lie.compose(T_icp, init_guess)
    model_dev = lie.compose(lie.transform_inverse(init_guess), pose_icp)
    diverged = jnp.linalg.norm(model_dev[:3, 3]) > cfg.icp.max_model_deviation
    new_pose = lie.orthonormalize(jnp.where(diverged, init_guess, pose_icp))
    model_dev = jnp.where(diverged, jnp.eye(4, dtype=jnp.float64), model_dev)
    thr_state = icp_ops.update_model_deviation(thr_state, model_dev)

    delta = lie.compose(new_pose, lie.transform_inverse(init_guess))
    g_corr = g._replace(
        points=lie.rotate_points(delta[:3, :3].astype(jnp.float32), g.points)
        + delta[:3, 3].astype(jnp.float32)
    )
    pre_keys = voxel_map.pack_key(
        voxel_map.voxel_of(g.points, cfg.map.voxel_size)
    )
    owner = _owner(pre_keys, n_shards)

    def insert_shard(m, d):
        gd = g_corr._replace(head=g_corr.head & (owner == d))
        m = voxel_map.insert_grouped(m, gd, cfg.map, keys=pre_keys)
        return voxel_map.evict_far(m, new_pose[:3, 3], cfg.map)

    new_map = jax.vmap(insert_shard)(
        state.map, jnp.arange(n_shards, dtype=jnp.int32)
    )

    new_state = ShardedKissState(
        map=new_map,
        pose=new_pose,
        pose_prev=jnp.where(state.num_poses == 0, new_pose, state.pose),
        first_pose=jnp.where(state.num_poses == 0, new_pose, state.first_pose),
        num_poses=state.num_poses + 1,
        threshold=thr_state,
    )
    metrics = {
        "icp_iterations": iters,
        "num_correspondences": n_corr,
        "map_voxels": jnp.sum(jax.vmap(voxel_map.num_voxels)(new_map)),
        "drops": jnp.sum(new_map.drops),
        "window_drops": g.window_drops + src_drops,
    }
    return new_state, new_pose, metrics


@partial(jax.jit, static_argnames=("cfg", "n_shards", "n_outer", "n_inner"))
def register_frame_jit(state, scan, cfg, n_shards, n_outer=2, n_inner=4):
    return register_frame(state, scan, cfg, n_shards, n_outer, n_inner)


# ---------------------------------------------------------------------------
# Combined scale axes: S streams x map sharded over D devices (dp x mp mesh)
# ---------------------------------------------------------------------------
#
# Scaling model (round-2 VERDICT next #9): a (dp, mp) grid runs dp
# independent SLAM streams, each with a D=mp-way sharded map of total
# capacity mp * cfg.map.capacity slots (~mp x one device's memory budget).
# Per-step cross-device traffic:
#   * mp axis: one (mp, N, 4)-f32 NN-winner argmin per GN outer round
#     (N = max_source_points; ~4096 x 16 B = 64 KB per round).
#   * dp axis: scalar metric all-reduces only.
# Everything else (candidate gather, GN reduce, insert, evict) is local to
# a device, so step time is flat in dp and near-flat in mp until the
# winner exchange dominates (N large or mp very wide).


def init_multi_state(cfg: PipelineConfig, n_streams: int, n_shards: int):
    """(S, D, ...) map leaves; (S, ...) pose/threshold leaves."""
    one = init_state(cfg, n_shards)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape).copy(), one
    )


def shard_multi_state(state, mesh, dp: str = "dp", mp: str = "mp"):
    """Map leaves sharded (dp, mp); per-stream scalars sharded (dp,)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    smap = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(dp, mp))), state.map
    )
    rest = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(dp))),
        state._replace(map=None)._asdict(),
    )
    return ShardedKissState(
        map=smap, **{k: v for k, v in rest.items() if k != "map"}
    )


@partial(jax.jit, static_argnames=("cfg", "n_shards", "n_outer", "n_inner"))
def batched_register_frame_jit(states, scans, cfg, n_shards, n_outer=2,
                               n_inner=4):
    """vmap over the stream axis of the map-sharded step; input shardings
    ((dp, mp) maps, (dp,) scans) propagate through jit and GSPMD inserts
    the mp-axis argmin exchange + dp-axis metric reductions."""
    return jax.vmap(
        lambda st, sc: register_frame(st, sc, cfg, n_shards, n_outer, n_inner)
    )(states, scans)
