from . import trajectory
from . import metrics
from . import profiling
from . import compile_cache

__all__ = ["trajectory", "metrics", "profiling", "compile_cache"]
