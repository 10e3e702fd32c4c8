"""Device-mesh sharding for multi-device scale.

The reference is single-process/single-host (ROS pub/sub only — SURVEY §2
"Communication backend"); its scale story stops at TBB. Here:

  * `stream_mesh` — a 1-D mesh sharding independent SLAM streams (data
    parallelism); per-stream state pytrees carry a leading stream
    axis sharded on it. Cross-stream metric reductions become XLA
    all-reduces inserted by GSPMD.
  * `sharded_multistream_step` — the full odometry step over a sharded
    batch of streams + a global psum'd metrics bundle; this is the
    "training step" analog the driver dry-runs on an N-device virtual mesh.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PipelineConfig
from ..ops.preprocess import Scan
from . import streams


def stream_mesh(devices=None, axis: str = "dp") -> Mesh:
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def grid_mesh(dp: int, mp: int, devices=None, axes=("dp", "mp")) -> Mesh:
    """2-D mesh for the combined scale axes: `dp` independent SLAM streams,
    each stream's voxel map sharded over `mp` devices
    (parallel/sharded_map.py). The map axis carries the per-iteration
    cross-shard NN argmin, the stream axis only metric all-reduces; with
    the cards joined all to all, the mesh shape follows the algorithm
    alone."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    assert len(devices) >= dp * mp, (len(devices), dp, mp)
    return Mesh(np.asarray(devices[: dp * mp]).reshape(dp, mp), axes)


def shard_streams(tree, mesh: Mesh, axis: str = "dp"):
    """Place a leading-stream-axis pytree with dimension-0 sharding."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(tree, sharding)


class GlobalMetrics(NamedTuple):
    mean_residual_rms: jnp.ndarray  # () f64 — all-reduced across the mesh
    total_correspondences: jnp.ndarray  # () i64
    max_icp_iterations: jnp.ndarray  # () i32
    mean_map_voxels: jnp.ndarray  # () f64


def _step_with_metrics(states, scans: Scan, cfg: PipelineConfig):
    states, outs = streams.batched_register_frame(states, scans, cfg)
    metrics = GlobalMetrics(
        mean_residual_rms=jnp.mean(outs.residual_rms),
        total_correspondences=jnp.sum(outs.num_correspondences.astype(jnp.int64)),
        max_icp_iterations=jnp.max(outs.icp_iterations),
        mean_map_voxels=jnp.mean(outs.map_voxels.astype(jnp.float64)),
    )
    return states, outs.pose, metrics


def sharded_multistream_step(mesh: Mesh, cfg: PipelineConfig, axis: str = "dp"):
    """Build the jitted sharded step.

    Inputs placed with `shard_streams` carry their stream-axis sharding into
    jit; GSPMD keeps per-stream state resident on its device and inserts
    the all-reduces for the global metrics. Use:

        mesh = stream_mesh()
        states = shard_streams(streams.init_batched_state(cfg, S), mesh)
        step = sharded_multistream_step(mesh, cfg)
        states, poses, metrics = step(states, shard_streams(scans, mesh))
    """
    return jax.jit(partial(_step_with_metrics, cfg=cfg))
