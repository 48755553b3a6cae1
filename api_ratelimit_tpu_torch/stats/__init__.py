from .store import Counter, Gauge, Histogram, Scope, Store, Timer, new_null_store
from .sinks import NullSink

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Scope",
    "Store",
    "Timer",
    "new_null_store",
    "NullSink",
]
