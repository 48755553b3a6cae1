from .units import Unit, unit_to_divider, unit_from_string
from .response import Code, RateLimitValue, DescriptorStatus, DoLimitResponse, HeaderValue
from .descriptors import Entry, Descriptor, LimitOverride, RateLimitRequest
from .config import RateLimit, RateLimitStats, ConfigError

__all__ = [
    "Unit",
    "unit_to_divider",
    "unit_from_string",
    "Code",
    "RateLimitValue",
    "DescriptorStatus",
    "DoLimitResponse",
    "HeaderValue",
    "Entry",
    "Descriptor",
    "LimitOverride",
    "RateLimitRequest",
    "RateLimit",
    "RateLimitStats",
    "ConfigError",
]
