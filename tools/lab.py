"""Perf lab on the GPU: synthetic HDL-64E inputs + warm state for quick
step experiments. Commands:

    python tools/lab.py time             # warm-step timing trials
    python tools/lab.py trace            # device trace -> op breakdown
    python tools/lab.py chain            # device-pipelined chain timing
    python tools/lab.py chain_trace      # ... and its op breakdown
    python tools/lab.py lio_chain        # device-pipelined LIO chain
    python tools/lab.py lio_chain_trace
    python tools/lab.py streams S        # S-stream unrolled aggregate

Environment knobs (LIS_GN_BACKEND, LIS_SRC_POINTS, ...) select the config;
see make_cfg. Traces go to traces/lab/ in the checkout.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from lidar_imu_slam_tpu import config as cfgmod, parallel  # noqa: E402
from lidar_imu_slam_tpu.host import synthetic  # noqa: E402
from lidar_imu_slam_tpu.models import kiss_icp  # noqa: E402
from lidar_imu_slam_tpu.ops.preprocess import preprocess_scan, pack_raw_scan  # noqa: E402
from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

N_SCANS = 22
PTS = 131072
TRACE_DIR = os.path.join(ROOT, "traces", "lab")


def make_cfg(neigh=8):
    backend = os.environ.get("LIS_GN_BACKEND", "xla")
    nn_points = int(os.environ.get("LIS_NN_POINTS", "0"))
    src_points = int(os.environ.get("LIS_SRC_POINTS", "4096"))
    sort = bool(int(os.environ.get("LIS_SORT", "0")))
    store = bool(int(os.environ.get("LIS_STORE_POINTS", "0")))
    outer = int(os.environ.get("LIS_UNROLL_OUTER", "0"))
    inner = int(os.environ.get("LIS_UNROLL_INNER", "0"))
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(
            num_scan_lines=64, max_points=PTS, min_range=2.5, max_range=80.0,
            sort_by_time=sort,
        ),
        map=cfgmod.MapConfig(
            voxel_size=1.0, max_range=80.0, capacity=1 << 17, neighborhood=neigh,
            nn_points=nn_points,
            store_points=store or backend == "xla",
            auto_rebuild=bool(int(os.environ.get("LIS_AUTO_REBUILD", "1"))),
            max_insert_voxels=int(os.environ.get("LIS_INSERT_VOXELS", "0")),
        ),
        icp=cfgmod.IcpConfig(
            max_map_points=int(os.environ.get("LIS_MAP_POINTS", "32768")),
            max_source_points=src_points,
            gn_backend=backend,
            batch_unroll_outer=outer,
            batch_unroll_inner=inner,
        ),
    )


def _raws():
    """The lab drive as packed host RawScans (rendered on every run)."""
    world = synthetic.make_world(
        seed=0, n_points=600_000, extent=(160.0, 40.0, 12.0)
    )
    gt = synthetic.make_trajectory(
        n_poses=N_SCANS, speed=8.0, yaw_rate=0.01, dt=0.1
    )
    raws = []
    for i, pose in enumerate(gt):
        xyz = synthetic.render_scan(world, pose, PTS, 2.5, 80.0, noise=0.02,
                                    seed=i)
        st = i * 0.1
        raws.append(pack_raw_scan(
            xyz, time=synthetic.azimuth_times(xyz, st), stamp=st,
            max_points=PTS,
        ))
    return raws


def load_scans(cfg):
    pre = jax.jit(lambda raw: preprocess_scan(raw, cfg.lidar))
    return [jax.block_until_ready(pre(r)) for r in _raws()]


def warm_state(cfg, scans, n=21):
    state = kiss_icp.init_state(cfg)
    for i in range(n):
        state, out = kiss_icp.register_frame_jit(state, scans[i], cfg)
    jax.block_until_ready(out.pose)
    return state


def cmd_time():
    cfg = make_cfg()
    scans = load_scans(cfg)
    state = warm_state(cfg, scans)
    for trial in range(4):
        t0 = time.perf_counter()
        n = 30
        for _ in range(n):
            s2, out = kiss_icp.register_frame_jit(state, scans[21], cfg)
        jax.block_until_ready(out.pose)
        print(f"trial {trial}: {(time.perf_counter()-t0)/n*1e3:.2f} ms/step "
              f"iters={int(out.icp_iterations)}")


def _trace_report(trace_fn, n_steps: int, top: int = 60):
    """Run trace_fn under the profiler and print the device's idle share
    and a per-op breakdown."""
    import shutil

    from lidar_imu_slam_tpu.utils.profiling import trace_device_summary

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR, create_perfetto_trace=True):
        trace_fn()
    summary = trace_device_summary(TRACE_DIR, top=top)
    for name, dur, count in summary["top"]:
        print(f"{dur / 1e3 / n_steps:9.3f} ms/step  x{count / n_steps:6.1f}  "
              f"{name[:72]}")
    print(f"--- device busy {summary['busy_us'] / 1e3 / n_steps:.3f} ms/step, "
          f"idle share {summary['idle_share']:.3f}")


def cmd_trace():
    cfg = make_cfg()
    scans = load_scans(cfg)
    state = warm_state(cfg, scans)

    def run():
        for _ in range(5):
            s2, out = kiss_icp.register_frame_jit(state, scans[21], cfg)
        jax.block_until_ready(out.pose)

    _trace_report(run, 5)


def _chain_setup(block: int = 11):
    """Shared builder for the device-pipelined chain experiments: the bench's
    chained mode at lab scale (map maintenance hoisted to block boundaries —
    a map-carrying lax.cond INSIDE the scan body copies every map slab per
    scan)."""
    import dataclasses
    import functools

    from lidar_imu_slam_tpu.ops import voxel_map

    cfg = make_cfg()
    body_cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, auto_rebuild=False, auto_evict=False)
    )
    raws = _raws()
    blocks = [
        jax.device_put(jax.tree.map(lambda *xs: jnp.stack(xs),
                                    *raws[i : i + block]))
        for i in range(0, N_SCANS - (N_SCANS % block), block)
    ]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_block(state, stacked):
        def body(st, raw):
            sc = preprocess_scan(raw, body_cfg.lidar)
            st, out = kiss_icp.register_frame(st, sc, body_cfg)
            return st, (out.pose, out.icp_iterations)

        state, outs = jax.lax.scan(body, state, stacked)
        new_map = voxel_map.evict_far(state.map, state.pose[:3, 3], cfg.map)
        cap = cfg.map.capacity
        need = (new_map.next_slot > cap - cap // 4) & (
            new_map.tombstones > cap // 16
        )
        new_map = jax.lax.cond(
            need, lambda mm: voxel_map.rebuild(mm, cfg.map), lambda mm: mm,
            new_map,
        )
        return state._replace(map=new_map), outs

    return cfg, blocks, run_block, block


def cmd_chain():
    cfg, blocks, run_block, block = _chain_setup()
    st0, (poses, _) = run_block(kiss_icp.init_state(cfg), blocks[0])
    jax.block_until_ready(poses)
    del st0
    n_timed = len(blocks) * block
    for trial in range(3):
        state = kiss_icp.init_state(cfg)
        t0 = time.perf_counter()
        all_iters = []
        for b in blocks:
            state, (poses, iters) = run_block(state, b)
            all_iters.append(iters)
        jax.block_until_ready(poses)
        dt = (time.perf_counter() - t0) / n_timed * 1e3
        iters = np.concatenate([np.asarray(x) for x in all_iters])
        print(f"trial {trial}: {dt:.2f} ms/scan fresh-chain  "
              f"iters={iters.astype(int).tolist()}")


def cmd_chain_trace():
    """Op breakdown of the device-pipelined chain body (the headline shape)."""
    cfg, blocks, run_block, block = _chain_setup()
    st0, (poses, _) = run_block(kiss_icp.init_state(cfg), blocks[0])
    jax.block_until_ready(poses)
    del st0

    def run():
        state = kiss_icp.init_state(cfg)
        for b in blocks:
            state, (poses, _) = run_block(state, b)
        jax.block_until_ready(poses)

    _trace_report(run, len(blocks) * block)


def _lio_chain_setup(block: int = 11):
    """Device-pipelined LIO chain (bench _bench_lio shape at lab scale)."""
    import dataclasses
    import functools

    from lidar_imu_slam_tpu.models import lio
    from lidar_imu_slam_tpu.ops import voxel_map

    cfg = make_cfg()
    cfg = cfg.replace(
        imu=dataclasses.replace(cfg.imu, max_samples_per_scan=16),
        ekf=dataclasses.replace(
            cfg.ekf,
            lidar_pose_trail=int(os.environ.get("LIS_TRAIL", "2")),
            # ICP-measured noise, not the reference's untested defaults
            # (same rationale as bench._bench_lio)
            lidar_pos_noise=0.02, lidar_ori_noise=0.005,
        ),
    )
    body_cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, auto_rebuild=False, auto_evict=False)
    )
    cap = cfg.imu.max_samples_per_scan

    # IMU consistent with the lab trajectory (same construction as
    # load_scans; see bench._bench_lio for why zero-motion IMU poisons
    # the EKF guess and inflates ICP refetch rounds)
    gt = synthetic.make_trajectory(
        n_poses=N_SCANS, speed=8.0, yaw_rate=0.01, dt=0.1
    )
    times, gyros, accs = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)

    def packet(i):
        lo, hi = np.searchsorted(times, (i * 0.1, (i + 1) * 0.1))
        hi = min(hi, lo + 10)
        return jax.tree.map(np.asarray, lio.pack_imu_packet(
            times[lo:hi] + 1e-3, gyros[lo:hi], accs[lo:hi], cap
        ))

    raws = _raws()
    packets = [packet(i) for i in range(N_SCANS)]
    blocks = [
        jax.device_put(jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[(raws[j], packets[j]) for j in range(i, i + block)],
        ))
        for i in range(0, N_SCANS - (N_SCANS % block), block)
    ]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_block(state, stacked):
        def body(st, inp):
            raw, pkt = inp
            sc = preprocess_scan(raw, body_cfg.lidar)
            st, out = lio.step(st, sc, pkt, body_cfg)
            return st, out.pose

        state, poses = jax.lax.scan(body, state, stacked)
        new_map = voxel_map.evict_far(
            state.odo.map, state.odo.pose[:3, 3], cfg.map
        )
        capn = cfg.map.capacity
        need = (new_map.next_slot > capn - capn // 4) & (
            new_map.tombstones > capn // 16
        )
        new_map = jax.lax.cond(
            need, lambda mm: voxel_map.rebuild(mm, cfg.map), lambda mm: mm,
            new_map,
        )
        return state._replace(odo=state.odo._replace(map=new_map)), poses

    return cfg, blocks, run_block, block, lio


def cmd_lio_chain():
    cfg, blocks, run_block, block, lio = _lio_chain_setup()
    st0, poses = run_block(lio.init_state(cfg), blocks[0])
    jax.block_until_ready(poses)
    del st0
    n_timed = len(blocks) * block
    for trial in range(3):
        state = lio.init_state(cfg)
        t0 = time.perf_counter()
        for b in blocks:
            state, poses = run_block(state, b)
        jax.block_until_ready(poses)
        dt = (time.perf_counter() - t0) / n_timed * 1e3
        print(f"trial {trial}: {dt:.2f} ms/scan fresh LIO chain")


def cmd_lio_chain_trace():
    cfg, blocks, run_block, block, lio = _lio_chain_setup()
    st0, poses = run_block(lio.init_state(cfg), blocks[0])
    jax.block_until_ready(poses)
    del st0

    def run():
        state = lio.init_state(cfg)
        for b in blocks:
            state, poses = run_block(state, b)
        jax.block_until_ready(poses)

    _trace_report(run, len(blocks) * block)


def cmd_streams(n_streams):
    cfg = make_cfg()
    bcfg = parallel.streams.batch_config(cfg)
    scans = load_scans(cfg)
    states = parallel.streams.init_batched_state(bcfg, n_streams)

    def batch_scan(i):
        idx = [min(i + s, N_SCANS - 1) for s in range(n_streams)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[scans[j] for j in idx])

    bscans = [batch_scan(i) for i in range(N_SCANS)]
    for i in range(2):
        states, outs = parallel.streams.batched_register_frame_jit(
            states, bscans[i], bcfg
        )
    jax.block_until_ready(outs.pose)
    t0 = time.perf_counter()
    for i in range(2, N_SCANS):
        states, outs = parallel.streams.batched_register_frame_jit(
            states, bscans[i], bcfg
        )
    jax.block_until_ready(outs.pose)
    agg = n_streams * (N_SCANS - 2) / (time.perf_counter() - t0)
    print(f"{n_streams}-stream unrolled aggregate: {agg:.1f} scans/s "
          f"({agg/n_streams:.2f}/stream)")


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("tools/lab.py measures a GPU; none found")
    enable_compile_cache()
    cmd = sys.argv[1] if len(sys.argv) > 1 else "time"
    if cmd == "time":
        cmd_time()
    elif cmd == "chain":
        cmd_chain()
    elif cmd == "chain_trace":
        cmd_chain_trace()
    elif cmd == "lio_chain":
        cmd_lio_chain()
    elif cmd == "lio_chain_trace":
        cmd_lio_chain_trace()
    elif cmd == "trace":
        cmd_trace()
    elif cmd == "streams":
        cmd_streams(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        raise SystemExit(f"unknown command {cmd}")
