"""Port of tools/hotpath_profile.py: the host-path profiler, a
deterministic profile of the flat_per_second request loop.

Answers "where does the host half of a should_rate_limit go?" with the
flat_per_second service stack (tools/service_stack.py: the reference
bench's config, the slab engine, its batch window; on the card at the
served deployment's 2^22 rows, W = 128, sketch on), driven from ONE thread
under a profiler of that thread and printed as a top-N cumulative table:

    python -m api_ratelimit_tpu_torch.tools.hotpath_profile   # 2000 requests
    ... -n 500 --top 10 --sort tottime
    ... --legacy        # pin the pre-vectorization path (HOST_FAST_PATH=false)
    ... --dispatch      # profile the device-OWNER thread
    ... --slab-split    # the gather/scan/scatter stage baseline
    ... --frontend      # one frontend worker over shm rings to an owner
    ... --device cpu    # the plain versions (default: cuda, the card)

Every arm runs on --device: cuda (the default; the engine raises without a
card) or cpu. --shard-split needs the multi-GPU engine, which is not
ported yet (ROADMAP item 10): it exits 2 saying so.

--dispatch profiles the dispatch loop's owner thread instead of the
request thread: the loop runs its take/pack/launch/redeem cycle under its
own profiler (DISPATCH_PROFILE=1, backends/dispatch.py) while this thread
drives traffic, and the owner's table is printed after close(). The
`lock.acquire` line is the owner parked waiting for work/readbacks — the
idle headroom; everything else is real per-cycle dispatch cost.

Single-thread on purpose: the profiler instruments only the calling
thread, so the dispatcher/device threads show up as one honest
`lock.acquire` line (the time THIS thread spends waiting on the launch
round trip) instead of half-attributed noise. That profiler is the
standard library's profile module, whose sys.setprofile hook is per
thread, at several times cProfile's overhead (the rate line is taken
under it): on Python 3.12 cProfile records every thread (sys.monitoring),
so the reference, which enables cProfile, mixes every thread into each
table. Use `--pyinstrument`
for a wall-clock sampling view when that package is installed.

Output contract (the reference's, pinned by tests/test_torch_tools.py): a
`[hotpath] rate=<N>/s requests=<N>` summary line (its path= and device=
fields after), then the standard pstats table whose header row contains
`ncalls  tottime`.
"""

from __future__ import annotations

import argparse
import io
import profile
import os
import pstats
import sys
import time

SHARD_SPLIT_ITEM = "10"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-n", type=int, default=2000, help="requests to drive")
    parser.add_argument("--top", type=int, default=25, help="rows to print")
    parser.add_argument(
        "--sort",
        default="cumulative",
        choices=["cumulative", "tottime", "ncalls"],
    )
    parser.add_argument(
        "--legacy",
        action="store_true",
        help="pin the legacy per-object host path (the A/B arm)",
    )
    parser.add_argument(
        "--dispatch",
        action="store_true",
        help="profile the dispatch loop's device-owner thread instead of "
        "the request thread (DISPATCH_PROFILE=1)",
    )
    parser.add_argument(
        "--frontend",
        action="store_true",
        help="profile one FRONTEND WORKER's hot loop end to end "
        "(decode -> match -> compose -> publish over shm rings to a "
        "local device owner) and print the native-vs-python split",
    )
    parser.add_argument(
        "--pyinstrument",
        action="store_true",
        help="wall-clock sampling profile instead of cProfile",
    )
    parser.add_argument(
        "--shard-split",
        action="store_true",
        help="print the ROUTED mesh dispatch owner's stage split "
        "(host bucket / pad+H2D / launch ns per mesh launch, "
        "parallel/sharded_slab.py shard_routing_snapshot) on a virtual "
        "CPU mesh, plus the per-shard row mix and padding waste",
    )
    parser.add_argument(
        "--shards",
        type=int,
        default=4,
        help="mesh size for --shard-split (default 4)",
    )
    parser.add_argument(
        "--slab-split",
        action="store_true",
        help="print the slab stage-split baseline (set-gather / scan / "
        "scatter ns per launch, SlabDeviceEngine.profile_slab_split) "
        "instead of a host profile",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the engine runs: cuda (default) or cpu",
    )
    args = parser.parse_args(argv)

    if args.shard_split:
        print(
            "[shard_split] needs the multi-GPU engine "
            "(parallel/sharded_slab.py), which is not ported yet: "
            f"ROADMAP item {SHARD_SPLIT_ITEM}",
            file=sys.stderr,
        )
        return 2
    if args.frontend:
        return _run_frontend_profile(args)
    if args.dispatch:
        # must be set BEFORE the service (and its DispatchLoop thread)
        # is built: the owner thread reads it once at startup
        os.environ["DISPATCH_PROFILE"] = "1"
    from . import service_stack

    service, cache, _store = service_stack.build_service(
        args.device, host_fast_path=not args.legacy
    )
    reqs = service_stack.flat_requests(2048)
    # warmup: compile/prime outside the profiled region
    for request in reqs[:64]:
        service.should_rate_limit(request)

    if args.slab_split:
        return _run_slab_split(cache, _store)
    if args.dispatch:
        return _run_dispatch_profile(service, cache, reqs, args)
    try:
        if args.pyinstrument:
            return _run_pyinstrument(service, reqs, args)
        prof = profile.Profile()
        t0 = time.perf_counter()
        prof.runcall(_drive, service, reqs, args.n)
        elapsed = time.perf_counter() - t0
        print(
            f"[hotpath] rate={round(args.n / elapsed)}/s requests={args.n} "
            f"path={'legacy' if args.legacy else 'fast'} "
            f"device={_device_label(cache.engine.device)}"
        )
        out = io.StringIO()
        stats = pstats.Stats(prof, stream=out)
        stats.sort_stats(args.sort).print_stats(args.top)
        print(out.getvalue())
        return 0
    finally:
        cache.close()


def _drive(service, reqs, n: int) -> None:
    for i in range(n):
        service.should_rate_limit(reqs[i % len(reqs)])


def _device_label(device) -> str:
    """The device a run measured: the card's name on CUDA, else "cpu"."""
    import torch

    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device).replace(" ", "_")
    return device.type


def _run_slab_split(cache, store) -> int:
    """The slab_split stage baseline: gather/scan/scatter per-launch ns
    on the engine's geometry, recorded into (and reported from) the
    ratelimit.slab.split.* runtime histograms /metrics renders.

    Output contract (the reference's): one `[slab_split] batch=<N>` line
    and one `[slab_split] ways=<W> rows=<N> device=<d>` line, then
    `<stage>_ns p50=<N> p99=<N>` per stage; then `[slab_split] metrics` and the exposition
    lines of the three split histograms (stats/prometheus.py render), which
    the printed rows are read from."""
    from ..stats import prometheus
    from . import service_stack

    try:
        engine = cache.engine
        result = engine.profile_slab_split(
            scope=store.scope("ratelimit").scope("slab"), iters=30
        )
        split = service_stack.slab_split(store)
        print(f"[slab_split] batch={result['batch']}")
        print(
            f"[slab_split] ways={engine.ways} rows={engine.shard_slots} "
            f"device={_device_label(engine.device)}"
        )
        for stage in ("gather_ns", "scan_ns", "scatter_ns"):
            h = split[stage]
            print(f"  {stage:<11} p50={h['p50']} p99={h['p99']}")
        print("[slab_split] metrics")
        for line in prometheus.render(store).splitlines():
            if line.startswith("ratelimit_slab_split_") or (
                line.startswith("# TYPE ratelimit_slab_split_")
            ):
                print(line)
        return 0
    finally:
        cache.close()


def _run_dispatch_profile(service, cache, reqs, args) -> int:
    """Drive traffic from a small thread pool (the owner loop only earns
    its keep under concurrency) and print the OWNER thread's profile."""
    from concurrent.futures import ThreadPoolExecutor

    loop = cache.engine.dispatch_loop
    if loop is None:
        print(
            "[hotpath] dispatch loop is not active (DISPATCH_LOOP off or "
            "direct mode); nothing to profile",
            file=sys.stderr,
        )
        cache.close()
        return 2

    def worker(tid: int) -> None:
        my = reqs[tid::4]
        for i in range(args.n // 4):
            service.should_rate_limit(my[i % len(my)])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(worker, range(4)))
    elapsed = time.perf_counter() - t0
    cache.close()  # stops the owner thread; its profile is final now
    print(
        f"[hotpath] rate={round(args.n / elapsed)}/s requests={args.n} "
        f"path=dispatch-owner device={_device_label(cache.engine.device)}"
    )
    if loop._profile is None:
        print("[hotpath] owner thread recorded no profile", file=sys.stderr)
        return 2
    out = io.StringIO()
    stats = pstats.Stats(loop._profile, stream=out)
    stats.sort_stats(args.sort).print_stats(args.top)
    print(out.getvalue())
    return 0


def _run_frontend_profile(args) -> int:
    """The FRONTEND_PROCS worker's view: a sidecar-backed service whose
    submits publish over shm rings to a device owner (running here on
    background threads, so the profiled REQUEST thread sees exactly what
    a worker process's handler thread sees: transport decode -> compiled
    matcher -> key compose -> row write -> shm publish -> verdict spin).
    Prints the standard pstats table plus a [native_split] block: which
    hot-loop stages run native and the per-stage ns from the runtime
    histograms.

    Output contract (pinned by tests/test_tools_platform.py): the
    `[hotpath] ... path=frontend-shm` line, a `[native_split]` line, then
    the pstats header row."""
    import tempfile

    from ..backends.cuda import CudaRateLimitCache, SlabDeviceEngine
    from ..backends.sidecar import SidecarEngineClient, SlabSidecarServer
    from ..limiter.base_limiter import BaseRateLimiter
    from ..ops import native
    from ..service.ratelimit import RateLimitService
    from ..stats.sinks import NullSink
    from ..stats.store import Store
    from ..utils.timeutil import RealTimeSource
    from . import service_stack

    td = tempfile.mkdtemp()
    sock = os.path.join(td, "owner.sock")
    ctl = sock + ".shmctl"
    engine = SlabDeviceEngine(
        RealTimeSource(),
        n_slots=1 << 16,
        device=args.device,
        buckets=(8, 128, 1024),
        batch_window_seconds=0.0005,
        max_batch=8192,
        block_mode=True,
    )
    server = SlabSidecarServer(sock, engine, shm_control_path=ctl)
    store = Store(NullSink())
    scope = store.scope("ratelimit")
    client = SidecarEngineClient(sock, scope=scope, shm_control_path=ctl)
    cache = CudaRateLimitCache(
        BaseRateLimiter(RealTimeSource()), engine=client
    )
    service = RateLimitService(
        runtime=service_stack.StaticRuntime(service_stack.FLAT),
        cache=cache,
        stats_scope=scope.scope("service"),
        time_source=RealTimeSource(),
    )
    reqs = service_stack.flat_requests(2048)
    for request in reqs[:64]:
        service.should_rate_limit(request)
    try:
        prof = profile.Profile()
        t0 = time.perf_counter()
        prof.runcall(_drive, service, reqs, args.n)
        elapsed = time.perf_counter() - t0
        print(
            f"[hotpath] rate={round(args.n / elapsed)}/s "
            f"requests={args.n} path=frontend-shm "
            f"device={_device_label(engine.device)}"
        )
        config = service.get_current_config()
        matcher_native = bool(
            config is not None
            and getattr(config.compiled, "native_active", False)
        )
        shm_active = client._shm is not None and not client._shm.dead
        print(
            f"[native_split] codec={'native' if native.available() else 'python'} "
            f"matcher={'native' if matcher_native else 'python'} "
            f"submit={'shm' if shm_active else 'socket'}"
        )
        snap = store.debug_snapshot()
        for label, key in (
            ("matcher_ns", "ratelimit.service.host.matcher_ms"),
            ("key_compose_ns", "ratelimit.host.key_compose_ms"),
            ("pack_ns", "ratelimit.host.pack_ms"),
            ("shm_submit_ns", "ratelimit.sidecar.shm_ms"),
        ):
            p50 = snap.get(f"{key}.p50")
            p99 = snap.get(f"{key}.p99")
            if p50 is None:
                continue
            print(
                f"  {label:<15} p50={round(p50 * 1e6)} p99={round(p99 * 1e6)}"
            )
        out = io.StringIO()
        stats = pstats.Stats(prof, stream=out)
        stats.sort_stats(args.sort).print_stats(args.top)
        print(out.getvalue())
        return 0
    finally:
        cache.close()
        server.close()
        engine.close()


def _run_pyinstrument(service, reqs, args) -> int:
    try:
        from pyinstrument import Profiler
    except ImportError:
        print(
            "[hotpath] pyinstrument is not installed in this environment; "
            "re-run without --pyinstrument",
            file=sys.stderr,
        )
        return 2
    profiler = Profiler()
    t0 = time.perf_counter()
    with profiler:
        for i in range(args.n):
            service.should_rate_limit(reqs[i % len(reqs)])
    elapsed = time.perf_counter() - t0
    print(f"[hotpath] rate={round(args.n / elapsed)}/s requests={args.n}")
    print(profiler.output_text(unicode=True, color=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
