from .timeutil import FakeTimeSource, RealTimeSource, TimeSource, calculate_reset

__all__ = ["FakeTimeSource", "RealTimeSource", "TimeSource", "calculate_reset"]
