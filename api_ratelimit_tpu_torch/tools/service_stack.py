"""The flat_per_second service stack, the port's copy of the builders the
reference's tools/hotpath_profile.py takes from bench.py (`_FLAT`,
`_StaticRuntime`, `_requests_for`, `_build_service`, `_slab_split`).

One rule (`api_key`, 10^9 a second, so nothing is ever over its limit), a
request stream cycling 1024 keys, and the service over the windowed engine:
a 200us batch window, the dispatch loop, every bucket precompiled. On the
card the engine has the served deployment's width: 2^22 rows at W = 128
with the production buckets (128, 1024, 8192, 65536) and the heavy-hitter
sketch on (128 lanes), so one launch runs the way scan, the apply and the
sketch update kernels. On the CPU it keeps the
reference's bench geometry (2^18 rows, the plain versions' W = 4, buckets
from 8). tools/hotpath_profile.py builds on it; a port benchmark may too.
"""

from __future__ import annotations

import random

FLAT = """\
domain: bench
descriptors:
  - key: api_key
    rate_limit: {unit: second, requests_per_unit: 1000000000}
"""

# the slab split's runtime histograms (SlabDeviceEngine.profile_slab_split
# with scope ratelimit.slab) and the short names the tools print
SLAB_STAGE_HISTOGRAMS = (
    ("gather_ns", "ratelimit.slab.split.gather_ms"),
    ("scan_ns", "ratelimit.slab.split.scan_ms"),
    ("scatter_ns", "ratelimit.slab.split.scatter_ms"),
)


class StaticRuntime:
    """A runtime loader that serves one YAML text as config.bench."""

    def __init__(self, yaml_text: str):
        self._yaml = yaml_text

    def snapshot(self):
        outer = self

        class Snap:
            def keys(self):
                return ["config.bench"]

            def get(self, key):
                return outer._yaml

        return Snap()

    def add_update_callback(self, cb):
        pass


def flat_requests(n: int) -> list:
    """n flat_per_second requests: one api_key descriptor, 1024 keys."""
    from ..models.descriptors import Descriptor, RateLimitRequest

    return [
        RateLimitRequest(
            domain="bench", descriptors=(Descriptor.of(("api_key", f"k{i % 1024}")),)
        )
        for i in range(n)
    ]


def build_service(device="cuda", host_fast_path: bool = True):
    """(service, cache, store) over the flat_per_second rule on `device`,
    the backend's stats on the store; host_fast_path=False pins the legacy
    per-object host path."""
    import torch

    from ..backends.cuda import CudaRateLimitCache
    from ..limiter.base_limiter import BaseRateLimiter
    from ..service.ratelimit import RateLimitService
    from ..stats.sinks import NullSink
    from ..stats.store import Store
    from ..utils.timeutil import RealTimeSource

    on_card = torch.device(device).type == "cuda"
    store = Store(NullSink())
    base = BaseRateLimiter(
        time_source=RealTimeSource(),
        jitter_rand=random.Random(0),
        expiration_jitter_max_seconds=0,
        local_cache=None,
    )
    cache = CudaRateLimitCache(
        base,
        n_slots=1 << 22 if on_card else 1 << 18,
        batch_window_seconds=0.0002,
        max_batch=8192,
        stats_scope=store.scope("ratelimit"),
        buckets=(128, 1024, 8192, 65536) if on_card else (8, 32, 128, 1024, 8192),
        device=device,
        hotkey_lanes=128,
        hotkey_k=16,
        precompile=True,
    )
    service = RateLimitService(
        runtime=StaticRuntime(FLAT),
        cache=cache,
        stats_scope=store.scope("ratelimit").scope("service"),
        time_source=RealTimeSource(),
        host_fast_path=host_fast_path,
    )
    return service, cache, store


def slab_split(store) -> dict:
    """Per-launch slab-stage count/p50/p99 (ns) from the runtime histograms
    profile_slab_split recorded."""
    hists = store.metrics_snapshot()["histograms"]
    out = {}
    for short, name in SLAB_STAGE_HISTOGRAMS:
        h = hists.get(name)
        if h and h["count"]:
            out[short] = {
                "count": h["count"],
                "p50": round(h["p50"] * 1e6),
                "p99": round(h["p99"] * 1e6),
            }
    return out
