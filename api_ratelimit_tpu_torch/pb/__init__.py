"""Port of api_ratelimit_tpu/pb: the generated Envoy protobuf modules and the
gRPC service glue.

The message modules are the reference's protoc output byte for byte (their
serialized descriptors included), except that protoc's absolute `envoy.*`
imports are qualified as `api_ratelimit_tpu_torch.pb.envoy.*`. The reference
puts its own directory on sys.path to resolve them; this package edits no
sys.path, so `import envoy` can never resolve to either package's copy by
accident. Both packages may be imported into one interpreter in either
order: protobuf's default pool accepts the second registration of the same
file bytes and hands back the same message classes.
"""

from __future__ import annotations

from .envoy.api.v2.core import base_pb2 as core_v2
from .envoy.api.v2.ratelimit import ratelimit_pb2 as ratelimit_v2
from .envoy.config.core.v3 import base_pb2 as core_v3
from .envoy.extensions.common.ratelimit.v3 import ratelimit_pb2 as common_ratelimit_v3
from .envoy.service.ratelimit.v2 import rls_pb2 as rls_v2
from .envoy.service.ratelimit.v3 import rls_pb2 as rls_v3
from .grpc_health_pb.health.v1 import health_pb2

__all__ = [
    "core_v3",
    "common_ratelimit_v3",
    "rls_v3",
    "core_v2",
    "ratelimit_v2",
    "rls_v2",
    "health_pb2",
]
