from .ratelimit import RateLimitService, ServiceError

__all__ = ["RateLimitService", "ServiceError"]
