from .cache import RateLimitCache
from .cache_key import CacheKey, generate_cache_key
from .base_limiter import BaseRateLimiter, LimitInfo
from .local_cache import LocalCache, LocalCacheStats

__all__ = [
    "RateLimitCache",
    "CacheKey",
    "generate_cache_key",
    "BaseRateLimiter",
    "LimitInfo",
    "LocalCache",
    "LocalCacheStats",
]
