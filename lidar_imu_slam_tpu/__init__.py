"""lidar_imu_slam_tpu — LiDAR-inertial odometry / SLAM framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
C++/ROS stack (Oreoluwa-Se/Lidar-Imu-Slam): KISS-ICP-style point-to-point
registration against a voxel-hash local map, constant-velocity and IMU motion
compensation, and a 170-dim quaternion error-state EKF — expressed as one
jit-compiled, static-shape, functional step over a state pytree.

Design stance (not a port):
  * every per-scan computation is a pure function `step(state, scan) -> (state, out)`
  * dynamic containers (robin_map, deques, Eigen dynamic matrices) become
    fixed-capacity arrays with validity masks
  * TBB shared-memory parallelism becomes XLA data parallelism on one chip;
    multi-stream scale via `vmap`, multi-chip via `jax.sharding` + shard_map.

Precision policy: f32 for point kernels (with translation-centered GN for
conditioning), f64 for pose composition and EKF covariance. x64 is enabled at
import because the estimation core needs it for ATE parity with the all-f64
Eigen reference.
"""

import jax

# The estimation core (pose composition, EKF covariance) requires f64.
jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from . import config  # noqa: E402
from . import ops  # noqa: E402
from . import models  # noqa: E402
from . import utils  # noqa: E402

__all__ = ["config", "ops", "models", "utils", "__version__"]
