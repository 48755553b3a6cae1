"""A gRPC load process for a frontend fleet (cmd/service_cmd.py).

    python -m api_ratelimit_tpu_torch.tools.fleet_client --port 8081 \\
        --seconds 10 --threads 16 --seed 1 --out client1.json

Each thread holds its own channel (its own TCP connection, so SO_REUSEPORT
spreads the threads over the fleet's workers) and sends v3 ShouldRateLimit
calls on domain "proc" until the time is up: 1-3 descriptors a call, Zipf(1.1)
keys over --keys (a user, a (tenant, path) pair or an ip, as the process rules
of chip_smoke.py lay them out), a hits_addend of 1-3 one call in ten. Until
--shared-until seconds into the run, one call in --shared-every also carries
one more descriptor with one hit on a shared key: ("shared", "s<j>") for j
below --shared-keys, or, with --conc-keys, every other one on ("conc",
"c<j>"); such a call sends hits_addend 0 (one hit), so a key's admitted
calls are exactly its admitted hits. Each thread walks the shared keys in
turn from its index among all load threads (this process's first is
--thread-offset), so load processes given consecutive offsets spread the
shared calls evenly over the keys. Calls wait for the channel to be ready
and have --timeout seconds.

The output (JSON) holds the calls, descriptors and hits sent, every answered
call as (unix time it started, latency in ms), each shared key's OK and
OVER_LIMIT answers, and every failed call as (seconds since the start, unix
time, thread, gRPC status name, its details), and every answered shared-key call as
(key, unix time it started, unix time it was answered, 1 for OK or 0).
Imports grpc,
numpy and the generated protobuf modules only: no torch, no card.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

V3_PATH = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"


def zipf_keys(rng, n: int, n_keys: int, s: float = 1.1) -> np.ndarray:
    cdf = np.cumsum(np.arange(1, n_keys + 1, dtype=np.float64) ** -s)
    return np.searchsorted(cdf, rng.random(n) * cdf[-1]).astype(np.int64)


def descriptor(k: int) -> list:
    """One descriptor for key id k: a user, a (tenant, path) pair or an ip."""
    kind = k % 3
    if kind == 0:
        return [("user", f"u{k}")]
    if kind == 1:
        return [("tenant", f"t{k % 97}"), ("path", f"/p{k}")]
    return [("ip", f"10.{k >> 16}.{(k >> 8) & 255}.{k & 255}")]


def thread_stream(seed: int, n: int, n_keys: int, shared_every: int, shared_keys: int, conc_keys: int,
                  offset: int = 0):
    """n calls: (descriptor groups, hits_addend, shared key name or None).
    The thread's j-th shared call of a kind goes to key (offset + j) mod
    that kind's key count, so threads with consecutive offsets spread their
    shared calls evenly over the keys however few calls each completes."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 4, n)
    keys = zipf_keys(rng, int(sizes.sum()), n_keys)
    hits = np.where(rng.random(n) < 0.1, rng.integers(1, 4, n), 0)
    out, at, n_shared, n_conc = [], 0, 0, 0
    for i, size in enumerate(sizes.tolist()):
        group = [descriptor(int(k)) for k in keys[at : at + size]]
        at += size
        shared = None
        if shared_every and i % shared_every == shared_every - 1 and shared_keys:
            if conc_keys and (i // shared_every) % 2:
                shared = ("conc", f"c{(offset + n_conc) % conc_keys}")
                n_conc += 1
            else:
                shared = ("shared", f"s{(offset + n_shared) % shared_keys}")
                n_shared += 1
        out.append((group, int(hits[i]), shared))
    return out


def serialize(rls_v3, group, hits: int, shared) -> bytes:
    req = rls_v3.RateLimitRequest(domain="proc", hits_addend=0 if shared else hits)
    for d in group + ([[shared]] if shared else []):
        entry = req.descriptors.add()
        for k, v in d:
            entry.entries.add(key=k, value=v)
    return req.SerializeToString()


def run(args) -> dict:
    import grpc

    from ..pb import rls_v3

    per_thread = int(args.max_calls)
    streams = [
        thread_stream(args.seed * 1000 + t, per_thread, args.keys, args.shared_every, args.shared_keys, args.conc_keys,
                      offset=args.thread_offset + t)
        for t in range(args.threads)
    ]
    lock = threading.Lock()
    result = {"calls": 0, "descriptors": 0, "hits": 0, "lat_ms": [], "failures": [], "shared": {}, "shared_calls": []}
    start = max(time.time(), float(args.start_at))
    time.sleep(max(0.0, start - time.time()))
    t_end = time.monotonic() + float(args.seconds)
    t0 = time.monotonic()

    def worker(t: int) -> None:
        calls = descs = hits = 0
        lat, failures, shared, shared_calls = [], [], {}, []
        # a subchannel pool of its own: the thread's channel opens its own
        # TCP connection instead of sharing the process's
        with grpc.insecure_channel(
            f"127.0.0.1:{args.port}", options=[("grpc.use_local_subchannel_pool", 1)]
        ) as ch:
            call = ch.unary_unary(V3_PATH, request_serializer=None, response_deserializer=None)
            i = 0
            while time.monotonic() < t_end and i < per_thread:
                group, h, key = streams[t][i]
                if key is not None and time.monotonic() - t0 >= args.shared_until:
                    key = None
                body = serialize(rls_v3, group, h, key)
                i += 1
                c0 = time.perf_counter()
                t_call = time.time()
                try:
                    raw = call(body, timeout=args.timeout, wait_for_ready=True)
                except grpc.RpcError as e:
                    failures.append([round(time.monotonic() - t0, 4), time.time(), t, e.code().name, e.details()])
                    continue
                ms = (time.perf_counter() - c0) * 1e3
                lat.append((t_call, ms))
                calls += 1
                n_desc = len(group) + (key is not None)
                descs += n_desc
                hits += n_desc * (max(1, h) if key is None else 1)
                if key is not None:
                    resp = rls_v3.RateLimitResponse.FromString(raw)
                    code = resp.statuses[-1].code
                    ok = code == rls_v3.RateLimitResponse.OK
                    slot = shared.setdefault(f"{key[0]}:{key[1]}", [0, 0])
                    slot[0 if ok else 1] += 1
                    shared_calls.append([f"{key[0]}:{key[1]}", t_call, t_call + ms / 1e3, int(ok)])
        with lock:
            result["calls"] += calls
            result["descriptors"] += descs
            result["hits"] += hits
            result["lat_ms"].extend(lat)
            result["failures"].extend(failures)
            result["shared_calls"].extend(shared_calls)
            for k, (ok, over) in shared.items():
                slot = result["shared"].setdefault(k, [0, 0])
                slot[0] += ok
                slot[1] += over

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(args.threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    result["seconds"] = time.monotonic() - t0
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", type=int, required=True, help="the fleet's GRPC_PORT")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--threads", type=int, default=16)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--keys", type=int, default=1 << 16, help="the Zipf universe")
    parser.add_argument("--shared-every", type=int, default=8)
    parser.add_argument("--shared-keys", type=int, default=16)
    parser.add_argument("--conc-keys", type=int, default=0)
    parser.add_argument("--shared-until", type=float, default=1e9, help="seconds into the run")
    parser.add_argument("--thread-offset", type=int, default=0,
                        help="this process's first thread's index among all load threads")
    parser.add_argument("--max-calls", type=int, default=6000, help="per thread")
    parser.add_argument("--timeout", type=float, default=30.0)
    parser.add_argument("--start-at", type=float, default=0.0, help="unix time to start at")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    result = run(args)
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
