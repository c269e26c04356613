from .profiling import cuda_event_ms, device_memory_stats
