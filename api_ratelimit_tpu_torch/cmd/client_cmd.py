"""Port of api_ratelimit_tpu/cmd/client_cmd.py: the CLI gRPC test client
(src/client_cmd/main.go:39-74).

    python -m api_ratelimit_tpu_torch.cmd.client_cmd \
        -dial_string localhost:8081 -domain mongo_cps \
        -descriptors database=users,database=default

Sends one ShouldRateLimit and prints the response. Descriptors are
key=value pairs separated by commas; repeat -descriptors for multiple
descriptors in one request.
"""

from __future__ import annotations

import argparse
import sys

import grpc

from ..pb import common_ratelimit_v3, rls_grpc, rls_v3


def parse_descriptor(spec: str):
    descriptor = common_ratelimit_v3.RateLimitDescriptor()
    for pair in spec.split(","):
        if not pair:
            continue
        key, sep, value = pair.partition("=")
        if not sep:
            raise ValueError(f"descriptor entry {pair!r} must be key=value")
        descriptor.entries.add(key=key, value=value)
    return descriptor


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-dial_string",
        default="localhost:8081",
        help="url of ratelimit server",
    )
    parser.add_argument("-domain", default="", help="rate limit configuration domain")
    parser.add_argument(
        "-descriptors",
        action="append",
        default=[],
        help="descriptor list as comma-separated key=value pairs; repeatable",
    )
    parser.add_argument(
        "-hits_addend", type=int, default=0, help="hits addend (0 = default 1)"
    )
    args = parser.parse_args(argv)

    request = rls_v3.RateLimitRequest(domain=args.domain, hits_addend=args.hits_addend)
    for spec in args.descriptors:
        request.descriptors.append(parse_descriptor(spec))

    with grpc.insecure_channel(args.dial_string) as channel:
        stub = rls_grpc.RateLimitServiceV3Stub(channel)
        try:
            response = stub.ShouldRateLimit(request, timeout=10.0)
        except grpc.RpcError as e:
            print(f"request error: {e.code().name}: {e.details()}", file=sys.stderr)
            return 1
    print("response:", response)
    return 0


if __name__ == "__main__":
    sys.exit(main())
