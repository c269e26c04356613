from .checks import nan_filled_empty
from .profiling import cuda_event_ms, device_memory_stats
