from . import lie
from . import precise
from . import stats
from . import preprocess
from . import imu
from . import voxel_map
from . import deskew
from . import ffmath
from . import icp_gn
from . import pose_chain
from . import icp

__all__ = [
    "lie", "precise", "stats", "preprocess", "imu", "voxel_map", "deskew",
    "ffmath", "icp_gn", "pose_chain", "icp",
]
