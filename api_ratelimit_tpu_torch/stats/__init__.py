from .store import Counter, Gauge, Histogram, Scope, Store, Timer, new_null_store
from .sinks import NullSink, StatsdSink, TestSink

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Scope",
    "Store",
    "Timer",
    "new_null_store",
    "NullSink",
    "StatsdSink",
    "TestSink",
]
