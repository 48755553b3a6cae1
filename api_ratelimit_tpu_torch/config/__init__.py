from .loader import (
    ConfigDoc,
    ConfigFile,
    RateLimitConfig,
    build_config,
    load_config,
    parse_config_files,
)

__all__ = [
    "ConfigDoc",
    "ConfigFile",
    "RateLimitConfig",
    "build_config",
    "load_config",
    "parse_config_files",
]
