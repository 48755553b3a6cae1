from .timeutil import (
    FakeTimeSource,
    RealTimeSource,
    SkewableTimeSource,
    TimeSource,
    calculate_reset,
    install_process_time_source,
    process_time_source,
)

__all__ = [
    "FakeTimeSource",
    "RealTimeSource",
    "SkewableTimeSource",
    "TimeSource",
    "calculate_reset",
    "install_process_time_source",
    "process_time_source",
]
