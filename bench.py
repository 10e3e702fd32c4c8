"""Benchmark: 64-beam scans/sec through the full odometry pipeline.

Runs the flagship KISS-ICP pipeline (the reference's wired end-to-end path:
reference src/odom_run.cpp:154-185) on synthetic 64-beam-scale scans on
the GPU JAX sees; it refuses to run on any other platform. ALL timed modes
are END-TO-END: the per-scan device preprocess (range gate, time handling,
packing) runs INSIDE the timed loop.

Modes, in order (the headline JSON line is RE-PRINTED after every completed
mode, so a run cut short still reports everything finished so far):

  1. device-pipelined: the whole scan chain as ONE lax.scan program whose
     body is preprocess + register (zero per-step host dispatch). The
     headline mode; also yields the trajectory for `ate_m` and a synced
     per-block latency.
  2. LIO: the lidar-inertial step (EKF predict + IMU deskew + ICP),
     device-pipelined the same way; also yields `lio_ate_m`.
  3. multi-stream pipelined: S independent SLAM streams vmapped inside the
     lax.scan body — aggregate scans/s = streams * steps / time.
  4. Monte-Carlo: S perturbed ensemble streams at VLP-16 scale
     (BASELINE config 5), >=20 steps, per-stream tracking asserted.
  5. classic-f64 anchor: the same drive through the classic f64 XLA path
     (gn_backend="xla") for `ate_vs_f64_ratio` — the fast float-float
     carrier must hold the classic path's accuracy.

Prints ONE JSON line per completed mode (same schema, monotonically more
`extra` keys; the LAST line is the result):

  {"metric": "scans_per_sec_64beam_e2e", "value": N, "unit": "scans/s",
   "device": {...}, "extra": {...}}

Exits non-zero if any mode failed. Cells, metrics and their bounds are not
defined yet (ROADMAP A1).
"""

import json
import os
import sys
import time
import traceback

import numpy as np


def _mark(msg):
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr)
    sys.stderr.flush()


_T0 = time.perf_counter()
_EXTRA = {}
_CANDIDATES = {}  # headline-eligible 64-beam e2e rates
_DEVICE = {}


def _emit(**updates):
    """Fold `updates` into the extras and (re)print the headline line.

    Keys in _CANDIDATES (64-beam end-to-end modes) compete for the
    headline; non-64-beam modes report via extras only.
    """
    _EXTRA.update(updates)
    best = max(_CANDIDATES.values()) if _CANDIDATES else 0.0
    print(
        json.dumps(
            {
                "metric": "scans_per_sec_64beam_e2e",
                "value": best,
                "unit": "scans/s",
                "device": _DEVICE,
                "extra": _EXTRA,
            }
        ),
        flush=True,
    )


def _device_info():
    """The GPU this run measures; refuses any other platform."""
    import subprocess

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {devices[0].platform!r}"
        )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card,
    }


def _ate(poses, gt, shift=0.0):
    from lidar_imu_slam_tpu.utils.trajectory import ate_displacement

    return ate_displacement(poses, gt, shift)


def _make_raws(n_scans, points_per_scan):
    """Host-resident packed RawScans (numpy pytrees): upload + device
    preprocess happen inside the timed loops. Scans are ROLLING-SHUTTER
    rendered (each point observed at its own interpolated pose) so the
    per-point timestamps describe real intra-scan motion — rigid renders
    with sweep timestamps make any deskewing estimator 'correct'
    distortion that never happened (~0.8 m of warp at 8 m/s). The render is
    not part of anything being measured."""
    from lidar_imu_slam_tpu.host import synthetic
    from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan

    world = synthetic.make_world(
        seed=0, n_points=600_000, extent=(160.0, 40.0, 12.0)
    )
    gt = synthetic.make_trajectory(
        n_poses=n_scans, speed=8.0, yaw_rate=0.01, dt=0.1
    )
    clouds = [
        synthetic.render_scan_rolling(
            world, gt[i], gt[min(i + 1, n_scans - 1)], 0.1,
            points_per_scan, 2.5, 80.0, noise=0.02, seed=i,
        )
        for i in range(n_scans)
    ]
    return [
        pack_raw_scan(
            pts,
            time=i * 0.1 + rel,
            stamp=i * 0.1,
            max_points=points_per_scan,
        )
        for i, (pts, rel) in enumerate(clouds)
    ]


def _make_cfg(points_per_scan, gn_backend="fused"):
    from lidar_imu_slam_tpu import config as cfgmod

    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(
            num_scan_lines=64, max_points=points_per_scan, min_range=2.5,
            max_range=80.0,
            # no preprocess-side sort: the scans carry per-point times and
            # the downsample's quantized-tau tiebreak keeps the reference's
            # earliest-point-wins semantics (fused_downsample docstring)
            sort_by_time=False,
            # scans always carry azimuth times here; static choice keeps the
            # rotation-model fallback out of the vmapped (batched) programs
            time_source="per_point",
        ),
        map=cfgmod.MapConfig(
            voxel_size=1.0, max_range=80.0, capacity=1 << 17, neighborhood=8,
            # perf mode: packed i32 slab only — the fused Pallas ICP reads
            # it exclusively; export decodes at ~3 mm quantization. The
            # classic XLA backend reads f32 stored points instead.
            store_points=(gn_backend == "xla"),
            # head-compacted insert (voxel_map._insert_grouped_compact):
            # per-voxel access ops run at 20480 head rows instead of 32768
            # point rows; this workload peaks at ~16k distinct insert
            # voxels/scan, drops stay 0 (round-4 A/B)
            max_insert_voxels=20480,
        ),
        # KITTI-realistic budgets: KISS-ICP's 1.5 m source downsample yields
        # ~2-4k points on HDL-64E frames. estimation_threshold relaxed from
        # the reference's 1e-4: measured SAME ATE (0.0078 vs 0.0080) at 2
        # instead of 5 GN iterations/scan
        icp=cfgmod.IcpConfig(
            max_map_points=32768, max_source_points=4096,
            estimation_threshold=5e-4, gn_backend=gn_backend,
            # CV deskew ON (the reference's wired path deskews,
            # icp.cpp:36-47): the scans are rolling-rendered, so the
            # estimator has real intra-scan distortion to remove. In the
            # fast path the twist scalars come out of pose_pre regardless,
            # so this costs only the per-point application.
            deskew=True,
        ),
    )


def main():
    from lidar_imu_slam_tpu.host import synthetic
    from lidar_imu_slam_tpu.utils.compile_cache import enable_compile_cache

    _DEVICE.update(_device_info())
    enable_compile_cache()
    # 120 scans: the chained/device-pipelined modes pay a fixed host
    # dispatch + final sync per measurement; more scans amortize it
    n_scans = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    n_streams = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    mc_streams = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    points_per_scan = 131072  # HDL-64E scale
    skip = set(os.environ.get("LIS_BENCH_SKIP", "").split(","))
    failed = []

    cfg = _make_cfg(points_per_scan)
    raws = _make_raws(n_scans, points_per_scan)
    gt = synthetic.make_trajectory(n_poses=n_scans, speed=8.0, yaw_rate=0.01, dt=0.1)
    _mark("data ready")

    def run(name, fn, *a):
        if name in skip:
            return
        try:
            fn(*a)
            _mark(f"{name} done")
        except Exception:
            failed.append(name)
            _mark(f"{name} FAILED\n{traceback.format_exc()}")
        # drop the mode's device blocks before the next mode compiles:
        # lingering HBM pressure from a prior mode measurably drags the
        # next (LIO ran 8% slower after chained without this, and ~35%
        # slower later in the full sequence)
        import gc

        gc.collect()

    # --- 1. device-pipelined (headline) + ATE + synced block latency -----
    def mode_chained():
        rate, poses, block_ms = _bench_chained(cfg, raws, n_scans)
        _CANDIDATES["chained"] = rate
        _emit(
            device_pipelined_scans_per_sec=rate,
            ate_m=_ate(poses, gt, shift=0.5),
            # host-synced wall per block of _BLOCK scans, over the block
            # size: includes one dispatch and one device-to-host sync
            synced_scan_ms_p50=float(np.percentile(block_ms, 50)) / _BLOCK,
            synced_scan_ms_p95=float(np.percentile(block_ms, 95)) / _BLOCK,
            points_per_scan=points_per_scan,
            gn_backend=cfg.icp.gn_backend,
        )

    run("chained", mode_chained)

    # --- 2. LIO (flagship lidar-inertial), device-pipelined ----------------
    def mode_lio():
        rate, poses, iters = _bench_lio(cfg, raws, n_scans)
        # LIO poses are at scan END (shift=1.0, see _ate)
        _emit(
            lio_scans_per_sec=rate,
            lio_ate_m=_ate(poses, gt, shift=1.0),
            lio_icp_iters_mean=float(np.mean(iters)),
            lio_icp_iters_max=int(np.max(iters)),
        )

    run("lio", mode_lio)

    # --- 3. multi-stream AND device-pipelined (vmap inside lax.scan) ------
    def mode_batched_chained():
        # capped at 60 scans: the device-side (block, S, scan...) windows
        # cost S x the single-stream block memory
        rate = _bench_batched_chained(cfg, raws[:60], min(n_scans, 60), n_streams)
        _CANDIDATES["batched_chained"] = rate
        _emit(
            multi_stream_pipelined_scans_per_sec=rate,
            streams=n_streams,
        )

    run("batched_chained", mode_batched_chained)

    # --- 4. 256-way Monte-Carlo (BASELINE config 5) at VLP-16 scale -------
    def mode_mc():
        mc_rate, mc_tracking, mc_steps = _bench_monte_carlo(mc_streams)
        _emit(
            monte_carlo_aggregate_scans_per_sec=mc_rate,
            monte_carlo_streams=mc_streams,
            monte_carlo_steps=mc_steps,
            # fraction of ensemble streams whose final pose is within
            # 0.5 m of ground truth — every perturbed stream must track
            # independently
            monte_carlo_tracking_frac=mc_tracking,
        )

    run("monte_carlo", mode_mc)

    # --- 5. classic-f64 anchor: same drive, xla backend, for the ATE ratio -
    def mode_f64():
        cfg64 = _make_cfg(points_per_scan, gn_backend="xla")
        rate, poses, _ = _bench_chained(cfg64, raws, n_scans)
        ate64 = _ate(poses, gt, shift=0.5)
        ate_fast = _EXTRA.get("ate_m")
        _emit(
            classic_f64_scans_per_sec=rate,
            ate_f64_m=ate64,
            # BASELINE parity bound: the fast float-float path must hold
            # the classic f64 path's accuracy (ratio ~1; both are vs the
            # same synthetic ground truth)
            ate_vs_f64_ratio=(
                ate_fast / max(ate64, 1e-9) if ate_fast is not None else None
            ),
        )

    run("f64_anchor", mode_f64)
    if failed:
        _mark(f"failed modes: {failed}")
        sys.exit(1)


_BLOCK = 10


def _bench_chained(cfg, raws, n_scans, block: int = _BLOCK):
    """Steps as lax.scan blocks over device-stacked RAW scans: the body is
    preprocess + register (the sequential pose dependency is preserved;
    per-step host dispatch AND preprocess serialization are removed). The
    state is donated so the map slabs update in place across calls.

    Map maintenance is hoisted OUT of the scan body to block boundaries:
    a lax.cond carrying the map pytree inside the scan body defeats XLA's
    loop-carry buffer aliasing and copies every map slab per scan; the
    same cond once per `block` scans in the donated program is cheap. The
    block
    predicate triggers a quarter-capacity early so `block` scans of
    allocations always fit before the next check.

    Returns (scans/s, all poses (n,4,4), per-block synced walls in ms —
    measured in a short separate pass so the throughput timing keeps its
    single final sync)."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from lidar_imu_slam_tpu.models import kiss_icp
    from lidar_imu_slam_tpu.ops import voxel_map
    from lidar_imu_slam_tpu.ops.preprocess import preprocess_scan

    # map maintenance (evict + conditional rebuild) at BLOCK boundaries:
    # a per-scan evict is a full key sweep + whole-slab rewrite; over one
    # block the pose moves ~v*dt*block (a few metres of eviction
    # hysteresis, see MapConfig.auto_evict)
    body_cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, auto_rebuild=False, auto_evict=False)
    )
    blocks = [
        jax.device_put(
            jax.tree.map(lambda *xs: jnp.stack(xs), *raws[i : i + block])
        )
        for i in range(0, n_scans - (n_scans % block), block)
    ]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_block(state, stacked):
        def body(st, raw):
            sc = preprocess_scan(raw, body_cfg.lidar)
            st, out = kiss_icp.register_frame(st, sc, body_cfg)
            return st, out.pose

        state, poses = jax.lax.scan(body, state, stacked)
        new_map = voxel_map.evict_far(
            state.map, state.pose[:3, 3].astype(jnp.float32), cfg.map
        )
        cap = cfg.map.capacity
        need = (new_map.next_slot > cap - cap // 4) & (
            new_map.tombstones > cap // 16
        )
        new_map = jax.lax.cond(
            need, lambda mm: voxel_map.rebuild(mm, cfg.map), lambda mm: mm,
            new_map,
        )
        return state._replace(map=new_map), poses

    # warm the compile on a throwaway state, then time a FRESH state over
    # the real trajectory. (Re-running the chain on the WARM state replays
    # scan 0 against the scan-(n-1) pose: every ICP starts ~15 m off the
    # guess and the 'steady state' number measures a teleport workload.
    # Fresh-state timing includes map fill-in, which is what real odometry
    # does.)
    state, poses = run_block(kiss_icp.init_state(cfg), blocks[0])  # compile
    np.asarray(poses)
    del state
    _mark("chained compiled")
    state = kiss_icp.init_state(cfg)
    all_poses = []
    t0 = time.perf_counter()
    for b in blocks:
        state, poses = run_block(state, b)
        all_poses.append(poses)
    all_poses = np.concatenate([np.asarray(p) for p in all_poses])  # host sync
    rate = len(blocks) * block / (time.perf_counter() - t0)

    # short per-block-synced pass for device-only latency (fresh state;
    # reuses the compiled program)
    state = kiss_icp.init_state(cfg)
    block_ms = []
    for b in blocks[:6]:
        t0 = time.perf_counter()
        state, poses = run_block(state, b)
        np.asarray(poses)
        block_ms.append((time.perf_counter() - t0) * 1000.0)
    del state
    return rate, all_poses, block_ms[1:]  # drop first (map near-empty)


def _bench_batched_chained(cfg, raws, n_scans, n_streams, block: int = _BLOCK):
    """S streams vmapped AND device-pipelined: lax.scan whose body is a
    vmapped preprocess + register over the stream axis — the production
    multi-stream feed shape (aggregate throughput, zero per-step host
    dispatch). No block-boundary rebuild: batched capacity carries the
    whole run with headroom (batch_config disables auto_rebuild — a
    per-stream cond would lower to select under vmap)."""
    import functools

    import jax
    import jax.numpy as jnp

    from lidar_imu_slam_tpu import parallel
    from lidar_imu_slam_tpu.ops.preprocess import preprocess_scan

    bcfg = parallel.streams.batch_config(cfg)

    # device-side stacking: upload each scan once (~2.6 MB), build the
    # (block, S, ...) windows on device instead of re-uploading 8x
    draws = [jax.device_put(r) for r in raws]

    def batch_raw(i):
        # staggered, clamped stream offsets (same rationale as the MC mode)
        idx = [min(i + s, n_scans - 1) for s in range(n_streams)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[draws[j] for j in idx])

    blocks = [
        jax.tree.map(
            lambda *xs: jnp.stack(xs), *[batch_raw(j) for j in range(i, i + block)]
        )
        for i in range(0, n_scans - (n_scans % block), block)
    ]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_block(states, stacked):
        def body(st, braw):
            sc = jax.vmap(lambda r: preprocess_scan(r, bcfg.lidar))(braw)
            st, out = parallel.streams.batched_register_frame(st, sc, bcfg)
            return st, out.pose

        return jax.lax.scan(body, states, stacked)

    states, poses = run_block(
        parallel.streams.init_batched_state(bcfg, n_streams), blocks[0]
    )  # compile on a throwaway state (fresh-state timing, see _bench_chained)
    np.asarray(poses)
    del states
    _mark("batched_chained compiled")
    states = parallel.streams.init_batched_state(bcfg, n_streams)
    t0 = time.perf_counter()
    for b in blocks:
        states, poses = run_block(states, b)
    np.asarray(poses)
    return n_streams * len(blocks) * block / (time.perf_counter() - t0)


def _bench_lio(cfg, raws, n_scans, block: int = _BLOCK):
    """The flagship LiDAR-inertial pipeline at the same 64-beam scale,
    device-pipelined like the chained lidar-only mode: synthetic 100 Hz IMU
    packets consistent with the bench trajectory; preprocess + EKF +
    registration inside the scan body, map maintenance at block boundaries
    (same carry-aliasing rationale as _bench_chained). Returns
    (scans/s, poses)."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from lidar_imu_slam_tpu.host import synthetic
    from lidar_imu_slam_tpu.models import lio
    from lidar_imu_slam_tpu.ops import voxel_map
    from lidar_imu_slam_tpu.ops.preprocess import preprocess_scan

    # packet budget sized to the 100 Hz stream: the EKF runs over the
    # STATIC packet capacity, so a 64-slot budget wastes ~54 masked
    # propagation steps per scan (~4x the EKF cost). lidar_pose_trail=2:
    # perf preset — no measurement reads trail slots (PARITY.md #22), so
    # the (170,170) trail bookkeeping buys nothing here; 30+14=44-dim state
    cfg = cfg.replace(
        imu=dataclasses.replace(cfg.imu, max_samples_per_scan=16),
        # lidar_pos/ori_noise tuned to the ICP's MEASURED per-scan noise
        # (~5 mm / ~0.01 deg on this workload) instead of the reference's
        # never-validated 0.1 m / 0.05 rad defaults (its EKF never runs,
        # odom_run.cpp:135-152): with the loose defaults the filter is
        # too confident in its own (gyro-driven) yaw to ever absorb the
        # seed-transient offset — measured: a frozen 0.2 deg yaw error
        # and 10-12 ICP iterations/scan vs 6 tuned (PARITY.md #27).
        ekf=dataclasses.replace(
            cfg.ekf, lidar_pose_trail=2,
            lidar_pos_noise=0.02, lidar_ori_noise=0.005,
        ),
    )
    body_cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, auto_rebuild=False, auto_evict=False)
    )
    cap = cfg.imu.max_samples_per_scan

    # IMU consistent with the bench trajectory (garbage zero-motion packets
    # against the 8 m/s trajectory made the EKF guess ~0.8 m off every scan
    # and ICP burned its refetch budget recovering: 44 vs ~100+ scans/s).
    # Static init still completes on the constant-velocity lead: specific
    # force ~ gravity (centripetal |a| = v*yaw_rate ~ 0.08 m/s^2).
    gt = synthetic.make_trajectory(
        n_poses=n_scans, speed=8.0, yaw_rate=0.01, dt=0.1
    )
    times, gyros, accs = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)

    def packet(i):
        lo, hi = np.searchsorted(times, (i * 0.1, (i + 1) * 0.1))
        hi = min(hi, lo + 10)
        return lio.pack_imu_packet(
            times[lo:hi] + 1e-3, gyros[lo:hi], accs[lo:hi], cap
        )

    packets = [jax.tree.map(np.asarray, packet(i)) for i in range(n_scans)]
    blocks = [
        jax.device_put(jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[(raws[j], packets[j]) for j in range(i, i + block)],
        ))
        for i in range(0, n_scans - (n_scans % block), block)
    ]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_block(state, stacked):
        def body(st, inp):
            raw, pkt = inp
            sc = preprocess_scan(raw, body_cfg.lidar)
            st, out = lio.step(st, sc, pkt, body_cfg)
            return st, (out.pose, out.icp_iterations)

        state, (poses, iters) = jax.lax.scan(body, state, stacked)
        new_map = voxel_map.evict_far(
            state.odo.map, state.odo.pose[:3, 3].astype(jnp.float32), cfg.map
        )
        capn = cfg.map.capacity
        need = (new_map.next_slot > capn - capn // 4) & (
            new_map.tombstones > capn // 16
        )
        new_map = jax.lax.cond(
            need, lambda mm: voxel_map.rebuild(mm, cfg.map), lambda mm: mm,
            new_map,
        )
        return state._replace(odo=state.odo._replace(map=new_map)), (poses, iters)

    state, (poses, _) = run_block(lio.init_state(cfg), blocks[0])  # compile
    np.asarray(poses)
    del state
    _mark("lio compiled")
    state = lio.init_state(cfg)
    all_poses = []
    all_iters = []
    t0 = time.perf_counter()
    for b in blocks:
        state, (poses, iters) = run_block(state, b)
        all_poses.append(poses)
        all_iters.append(iters)
    all_poses = np.concatenate([np.asarray(p) for p in all_poses])
    rate = len(blocks) * block / (time.perf_counter() - t0)
    all_iters = np.concatenate([np.asarray(x) for x in all_iters])
    return rate, all_poses, all_iters


def _bench_monte_carlo(n_streams, n_steps: int = 20):
    """BASELINE config 5: S concurrent perturbed SLAM streams at VLP-16
    scale (16k pts/scan), fixed-unroll ICP, one vmapped program. The
    ensemble shares one preprocessed scan + iid perturbations (that IS the
    workload — there is no per-stream preprocess to fold in); the shared
    preprocess runs inside the timed loop. Returns (aggregate scans/s,
    tracking fraction, n_steps)."""
    import jax

    from lidar_imu_slam_tpu import config as cfgmod
    from lidar_imu_slam_tpu import parallel
    from lidar_imu_slam_tpu.host import synthetic
    from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan, preprocess_scan

    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(
            num_scan_lines=16, max_points=16384, min_range=1.0, max_range=40.0,
            sort_by_time=False,  # tau rides the downsample key (see 64-beam cfg)
        ),
        # packed-only map + the vmapped fused f32 GN loop. The caps
        # (map rows / source points / nn points) trade accuracy for
        # throughput; an earlier sweep's max tracking errors were
        #   8192/2048/4: 0.042 m, 4096/1024/4: 0.033 m,
        #   2048/ 512/2: 0.114 m (chosen), 1024/256/4: 0.361 m (too close
        #   to the 0.5 m tracking bound)
        # and have to be swept again on the GPU (ROADMAP A6).
        # tracking_frac asserts every stream still tracks at the chosen
        # point. grid_z=32: the dense index is per-stream state (256
        # replicas); the default 128-deep z grid would cost 8 MB/stream
        # for a +-12 m world.
        map=cfgmod.MapConfig(
            voxel_size=1.0, max_range=40.0, capacity=1 << 13, neighborhood=8,
            nn_points=2, grid_z=32, store_points=False,
        ),
        icp=cfgmod.IcpConfig(
            max_map_points=2048, max_source_points=512, gn_backend="fused",
        ),
    )
    bcfg = parallel.streams.batch_config(cfg)
    world = synthetic.make_world(seed=1, n_points=200_000, extent=(60.0, 20.0, 8.0))
    gt = synthetic.make_trajectory(n_poses=n_steps + 2, speed=2.0, yaw_rate=0.01, dt=0.1)
    pre = jax.jit(lambda raw: preprocess_scan(raw, cfg.lidar))
    raws = []
    for i, pose in enumerate(gt):
        pts = synthetic.render_scan(world, pose, 16384, 1.0, 40.0, noise=0.02, seed=i)
        raws.append(pack_raw_scan(pts, stamp=i * 0.1, max_points=16384))

    states = parallel.streams.init_batched_state(bcfg, n_streams)
    key = jax.random.PRNGKey(0)

    def ensemble(i):
        # perturbed Monte-Carlo ensembles: same scan, iid point noise
        return parallel.streams.perturb_scans(
            pre(raws[i]), jax.random.fold_in(key, i), n_streams, 0.01
        )

    for i in range(2):
        states, outs = parallel.streams.batched_register_frame_step(
            states, ensemble(i), bcfg
        )
    np.asarray(outs.pose)
    _mark("monte_carlo compiled")
    t0 = time.perf_counter()
    for i in range(2, n_steps + 2):
        states, outs = parallel.streams.batched_register_frame_step(
            states, ensemble(i), bcfg
        )
    final_poses = np.asarray(outs.pose)  # (S, 4, 4) — also the host sync
    rate = n_streams * n_steps / (time.perf_counter() - t0)
    # per-stream tracking at bench scale: every perturbed stream must
    # independently stay within 0.5 m of the ground-truth pose of its
    # last scan
    gt_rel = np.linalg.inv(gt[0]) @ gt[n_steps + 1]
    err = np.linalg.norm(final_poses[:, :3, 3] - gt_rel[:3, 3], axis=-1)
    tracking = float(np.mean(err < 0.5))
    return rate, tracking, n_steps


if __name__ == "__main__":
    main()
