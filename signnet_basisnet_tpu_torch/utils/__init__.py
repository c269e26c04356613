from .checks import card_or_cpu, nan_filled_empty
from .logging import RunLogger
from .profiling import (Throughput, card_label, cuda_event_ms,
                        device_memory_stats, log_memory, timed, trace)
