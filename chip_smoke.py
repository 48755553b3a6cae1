"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):

1. build   nvcc-compiles every api_ratelimit_tpu_torch/csrc/*.cu source (one
           nvcc per source, all started together) into one library, and
           prints ptxas's lines for the apply and way scan kernels (the way
           scan's multi-algorithm instantiations also on a line of their
           own), after a line saying whether grpc, google.protobuf and yaml
           import here, with their versions.
2. parity  each kernel against its plain PyTorch version on the card,
           bit-exact, at every bucket (128 ... 65536): the way scan (with
           the shipped routing and in each of its two forms, set-major and
           per item, on its own; also on a 2^20 batch with over half of
           it in one set) and the apply at W in {4, 128} on adversarial
           inputs (segments across the apply kernel's 512-item tiles,
           window rollovers, all eviction tiers, one-set contention,
           padding lanes, counts >= 2^31); the
           sketch scan at sketch W in {4, 128} and lanes in {128, 1024} on
           adversarial planes (empty lanes, count ties, counts >= 2^31,
           fp-0 padding queries); the fused sketch update on the same
           geometries at b in {1, 1000, the buckets, 2^20} and at (8192
           lanes, W 4) and (4096 lanes, W 1) at the top bucket, with set 0
           forced (its victim lane matched, top-weight and fp_hi ties),
           wrapped-zero weights and runs without a candidate, its input
           planes unwritten; the decided apply (full and lean) and the
           standalone decide at near_ratio in {0.0, 0.8, 1.0}, with limits
           that put items under the near threshold, between it and the
           limit, crossing the limit, all over, at the f32 edge below 2^32,
           on counts >= 2^31 and padding. Then the apply's chained tile
           scan in every form (after, after with the sketch weight,
           decided, lean) at b in {1, 127, 1024, 65536, 2^20 - 37, 2^20},
           on one segment across every tile of 2^20 items, on a 2^20 batch
           whose sum wraps 2^32 ~8 times with segments starting right
           after each wrap, on all-zero hits, and the decided and lean
           forms on 20 fresh 2^20 seeds (a look-back race shows only now
           and then). The chaos campaign owner's geometry, never on the
           card before (W = 2 at b = 16 over 32 rows): the way scan in both
           instantiations and forms, the apply, and the victim tier's
           promote pass against the same pass on the CPU, over 16 fresh
           tables, all bit-exact. The build's ptxas lines print first.
3. engine  SlabDeviceEngine at 2^22 slots (128 MiB), W=128, with the
           production sketch (HOTKEY_LANES=128, HOTKEY_K=16), Zipf(1.1) over
           2^20 keys: 32 launches at the 65536 bucket plus the smaller
           buckets, the clock crossing window edges, against an engine
           whose three kernels are swapped for their plain versions;
           afters, table bytes, health, sketch planes and every drained
           top-K must be identical, and a sketch-off engine (slice 1's
           step) must give the same afters and table. Each sketch-on
           submit launches the fused sketch update once and the standalone
           scan never. Prints the 65536-item submit_rows medians with the
           sketch on and off, and one profiled submit of each: the
           sketch-on one may run at most 8 device activities more, each
           named.
4. serve   two servers (device="cuda", 2^22 slots) with a two-rule config
           built from a mapping answer /json requests that cross a limit:
           200 then 429, bodies equal to the same stream served on the CPU.
           First slice 1's arm (sketch off, trie walk into do_limit): the
           slab kernels' launch counters must rise and the sketch scan's
           stay 0. Then the default-settings server (hotkeys on, host fast
           path), with the same bodies: way_scan, slab_apply and
           sketch_update must rise together, one each a launch. A
           stats flush drains the sketch, and GET /debug/hotkeys on the
           debug server must equal the CPU server's document and name the
           hot descriptor.
5. decided the engine benchmark's decided tier (bench.py bench_engine_zipf)
           on the port: a 2^23-slot table (256 MiB), W=128, 33 blocks of
           2^20 ids from its 10M-key Zipf(1.1) stream (seed 0), 1 hit, limit
           100, divider 1, one `now`, near_ratio 0.8. As the reference
           times it: the ids staged on the card as int32 before timing,
           expanded there to its murmur3 fingerprints (checked bit for bit
           against the host operand's), _slab_step_sorted with the lean
           fused apply, the codes unsorted and the OVER bits packed on the
           card; a warm-up step, then 32 timed to one synchronize
           (decisions/s), the bit readback timed apart. Beside it the host
           operand stream of slab_step_decided (each uint32[7, 2^20]
           operand uploaded inside the timed loop, readback included) with
           the same OVER bits and health. The 33 x 2^20 codes against the
           exact oracle: false_over must be 0 and false_ok at most drops +
           100 x live evictions. Beside it, a second table through the plain
           versions for the first 4 blocks: codes, health and table bytes
           identical. Then slab_step_packed on one 65536 block against the
           plain versions (all 9 rows, health, table), its decision rows
           against the standalone decide kernel, and slab_update_and_decide
           against the plain versions. Launch counters: each stream runs
           way_scan and slab_apply_lean once per step and no other apply,
           the staged stream's way scans all in the set-major form; the
           packed step slab_apply_decide once. The way scan's two forms
           against the plain version on the stream's table, and one way
           scan captured in a CUDA graph whose replay must equal the eager
           call. One profiled staged step gives the device-busy share, the
           way scan's kernels' device ms and the top device items, and
           must hold no host-to-device copy.
6. compare the compare/select micro-benchmark's two kernels, sel and
   paths   chain, bit-exact against their plain versions at b = 2^20 (full
           range with INT_MIN, INT_MAX, 2^30 +- 1, 2^29 +- 1; the tool's own
           input), at b = 2^20 - 37 and on a buffer off 16-byte alignment;
           then the port's tool (api_ratelimit_tpu_torch/tools/
           microbench_compare_paths.py) in process at b = 2^20, which
           prints its JSON line: both kernels' launch counters must rise.
7. windowed the windowed serving path at the reference's default
           deployment (2^22 slots, W=128, the production sketch,
           TPU_BATCH_WINDOW=200us, max_batch 65536, buckets 128 ... 65536,
           precompiled) in three engines: the dispatch loop, leader-collects
           and direct. A serial stream (100 blocks of 1-64 Zipf(1.1) items,
           the clock crossing minutes) must give byte-identical results,
           tables, sketch planes and health in all three. Then, on fresh
           engines, 32 client threads submit single-descriptor blocks (2^13
           requests; 2^9 in direct mode, which serializes them): every
           key's count equals its hits (short keys at most drops + live
           evictions), decisions equal the requests, and each kernel's
           launch counter rises by the batches the arm reports. Prints
           requests/s, p50/p99 per request, the mean batch, the batches
           launched while another was in flight, and one profiled batch's
           device busy share.
8. algorithms the sibling algorithms (sliding window, GCRA, concurrency and
           its Release). (a) the way scan's multi-algorithm instantiation,
           both forms and the shipped routing, bit-exact to
           way_scan_plain(multi_algo=True) at W in {4, 128}, the buckets and
           a 2^20 batch 60% in one set, over tables of every algorithm's
           rows with sliding rows in their grace window beside fixed rows of
           lower count (the grace must change picks). (b) a served mix at
           the reference's default deployment (2^22 slots, W = 128, the
           production sketch, direct mode): 16 x 65536 Zipf(1.1) items over
           2^20 keys, a key's algorithm its id mod 4, one concurrency item
           in ten a release, GCRA burst ratio 1.5, `now` 7 s later each
           batch, through SlabDeviceEngine on the card and on the CPU:
           afters, health, table, sketch planes and the hotkeys document
           equal, the guard flipped on the first launch, its launches
           counted (the multi way scan and the sketch update once each a
           launch, no apply); the first 4 batches through
           slab_step_packed(multi_algo=True) against SetSlabOracle, item by
           item. Then /json and POST /release through HttpServer on the
           card and the CPU: equal answers, a release frees one slot. (c)
           bench.py's boundary-burst tier (64 keys, limit 100, 60 s
           windows, 4096 slots; the churn run, cap 32, TTL 40 s) on the
           card and the CPU: equal counts; fixed about 2x, sliding and GCRA
           within their bounds, the cap held, the TTL reclaiming. (d)
           slab_step_decided(multi_algo=True) at b = 2^20 over 2^23 slots:
           codes against SetSlabOracle, the set-major multi way scan and
           the decide kernel launched; the step staged on the card, its
           device ms and activities beside the fixed staged step's. Prints
           submit_rows medians and activities, fixed-only against flipped,
           and the multi body's device ms and activities.
9. process the process that boots, at the reference's default deployment
           (BACKEND_TYPE=cuda, 2^22 slots, SLAB_WAYS=0 so W = 128, the
           production sketch, HOST_FAST_PATH, direct mode, TPU_PRECOMPILE):
           Runner(new_settings(env)) in process over a runtime directory in
           the reference's layout, booted until gRPC health says SERVING
           (timed), beside a BACKEND_TYPE=memory Runner, both on one fake
           process clock. 4096 v3 ShouldRateLimit calls of 1-3 descriptors
           (Zipf(1.1) keys over 2^16, limits crossed), 64 legacy v2 calls
           and 64 /json POSTs go to both: every v3/v2 response byte-identical
           and every /json answer equal; the way scan, the apply and the
           fused sketch update each launch once a served launch; the slab's
           counters show no lossy eviction and one decision a descriptor.
           Then gRPC requests/s with p50/p99 per call, sequential and from
           32 client threads in this process, and one profiled 32-thread
           run's device busy share. A hot reload lowers a limit and adds a
           sliding-window domain (seen on /rlconfig): the lower limit
           answers, a fresh sliding key admits 5 and refuses the 6th, and
           the multi-algorithm way scan launches; a malformed file leaves
           the config in force; config_check_cmd passes the directory and
           refuses the malformed file. stop() pushes NOT_SERVING to an open
           health Watch and /healthcheck answers 500 before the ports
           close. Last, service_cmd in a subprocess with the same
           environment boots, answers client_cmd (a subprocess too) with
           the in-process runner's verdict, and on SIGTERM fails health and
           exits 0 within 30 s. Prints one "process:" JSON line.
10. observability the layers around the served engine, at phase 9's
           deployment with the reference's defaults for /metrics and the
           journey recorder, the tracer on (K_TRACING_ENABLED, exporting to
           a Zipkin collector this phase serves on 127.0.0.1),
           TPU_PROFILE_DIR set, FAILURE_MODE_DENY=deny and
           OVERLOAD_SHED_MODE=allow. 1024 v3 calls (1-3 descriptors,
           Zipf(1.1) keys over 2^16) byte-identical to a memory-backend
           Runner's on one fake clock, each launching the way scan, the
           apply and the fused sketch update once; the ladder's and the
           shed's counters and the degraded gauge read 0 and /healthcheck
           is plain OK; GET /metrics parses, its rules' total_hits sum to
           the stream's hits and ratelimit.build.{platform_id,device_count}
           read 2 and 1; /debug/journeys retains journeys with the pipeline's
           stages in order; after a stats flush drains the sketch, a call on
           the hottest descriptor carries the hotkey flag; the collector
           holds one server span per call. GET /debug/profile?ms=500 while a
           client thread drives calls answers 200, a second capture during
           it 429, and then 4 more captures in a row under that load: each
           capture's kernel counts print, and every one of the 5 traces
           must name way_scan_kernel, slab_apply_kernel and
           sketch_update_kernel (C10: the runner starts each profiler
           session with no launch in flight). A second runner with
           TPU_BATCH_WINDOW=200us (the dispatch loop) and the in-process
           recording tracer takes 8 client threads: a server span per call
           in /debug/traces, dispatch.batch spans linking exactly those,
           four dispatch.* stage spans under each, every journey with the
           batcher and owner stages in order, one launch of each kernel a
           batch. Last, sequential gRPC requests/s, p50 and p99 with
           tracing, journeys and exemplars on and off: two runners booted
           alike and warmed on the same calls take turns over one list of
           512 calls, 16 at a time in A B B A order, each serving the same
           calls; the on-off gap per block pair with its spread; the card's
           busy share of four profiled runs of 64 calls (A B B A); printed
           with the card's name and power limit, not claimed. Prints one
           "observability:" line.
11. warm restart and the redis oracle, at phase 9's deployment with
           SLAB_SNAPSHOT_DIR set (the periodic snapshot too rare to fire).
           (a) Runner A serves 1024 v3 calls (1-3 descriptors, Zipf(1.1)
           over 2^16 keys, one fake clock, limits crossed) beside a memory
           Runner and stops: the drain snapshot slab.snap is 60 + 2^22 x 32
           bytes and its payload equals the engine's last export_tables().
           Runner B boots from it, restores exactly the live rows A left,
           and its next 1024 calls are byte-identical to the memory Runner's,
           which served all 2048 without a restart; each kernel launches
           once a call. (b) Runner C calls snapshot_once() every 256 calls
           and is abandoned 1000 calls in without a drain; Runner D
           restores and serves 512 more beside a memory Runner that served
           them all: D never refuses what the memory Runner admits, and
           admits what it refuses at most as often for a key as the key's
           hits the crash lost. (c) 8
           client threads drive submit_rows at the 65536 bucket into a
           served engine while snapshot_once runs 5 times: the state lock's
           hold and the host drain of each export, each snapshot's ms,
           submit_rows p50/p99 with a snapshot in flight and without, and
           the restore of the last file to the first served launch (load
           and CRC, reconcile, upload). (d) the port's FakeRedisServer on
           127.0.0.1 (TCP) behind a BACKEND_TYPE=redis Runner and a cuda
           Runner, EXPIRATION_JITTER_MAX_SECONDS=0: 1024 v3 calls
           byte-identical, one launch of each kernel a call. Prints one
           "warm_restart:" JSON line with the card's name and power limit;
           nothing of it is claimed.
12. tiers  the victim tier and in-process leases at the default deployment
           (2^22 slots, W = 128, the production sketch, VICTIM_MAX_ROWS
           2^20, VICTIM_WATERMARK 0.85). (a) bench.py
           bench_keyspace_overload's structure at this geometry: one key a
           set a launch over 1024 of the 32768 sets, each set
           round-robining 5 x 128 = 640 keys (655,360 keys, 5x those sets'
           ways), limit 1, divider 3600, one clock, 1600 launches of 1024
           items, through a tier-off and a tier-on engine in turns, every
           decision held against VictimOracle: tier on, false admits <=
           drops + overflow_lost_count_sum, here exactly 0; tier off, false
           admits > 0; false overs 0 on both; the tier holds 1024 x 512
           rows, under its watermark. A plain-kernel twin of the tier-on
           engine (the way scan, apply and sketch update swapped for their
           plain versions) over 64 launches from launch 0 and 64 from
           launch 640 (from the kernel engine's table and tier there; every
           one promotes): afters every launch, then table bytes and tier
           rows identical. Launch counts: each launch one way scan, apply
           and sketch update, and each promote pass one way scan in its
           multi-algorithm instantiation (the reference's default). Prints
           demotes, promotes, tier rows, launch ms on each arm, the gap per
           tier event and the promote passes; the kernels line gains the
           multi way scan at a promote's shape. (b) phase 3's Zipf(1.1)
           stream at the 65536 bucket, tier on against off in A B B A
           order: submit_rows medians, the demote drain's host ms, the
           device activities of a submit in each arm with the added ones
           named. (c) snapshot_once of the tier-on engine, restore() into a
           fresh one: the restored tier equals the exported rows after
           reconcile_rows. (d) two Runners at phase 9's deployment,
           LEASE_ENABLED true and false, one fake clock that does not move:
           2048 sequential single-hit v3 calls on six hot keys, limits
           crossed, byte-identical; the lease arm answers some on the host,
           launches less and holds liabilities. Its drain snapshot's
           leases.snap restores into a third Runner, and per key the calls
           admitted before and after the restart stay within the limit.
           Last, LEASE_ENABLED with TPU_BATCH_WINDOW=200us (the dispatch
           loop) against the lease-off Runner on fresh keys. Prints one
           "tiers:" JSON line with the card's name and power limit;
           nothing of it is claimed.
13. fleet  the multi-process edge at the default deployment (2^22 slots, W =
           128, the production sketch, HOST_FAST_PATH, TPU_PRECOMPILE,
           TPU_BATCH_WINDOW=200us: the dispatch loop), driven by 8 client
           processes of 16 threads each (api_ratelimit_tpu_torch/tools/
           fleet_client.py: phase 9's stream of 1-3 descriptors, Zipf(1.1)
           over 2^16 keys; one call in eight also carries one descriptor,
           one hit, on one of 16 shared keys whose rule is a fixed window
           per hour, limit 8). (a) FRONTEND_PROCS=4, BACKEND_TYPE=cuda,
           SHM_RINGS=true: the master spawns the owner (cmd/sidecar_cmd.py)
           and four cuda-sidecar workers; 6 s of load measured, 11 s more
           for the owner's traces: no call fails, each shared key admits
           exactly min(8, calls) and gets more; only
           the owner (and this script) has a /dev/nvidia* file open, and
           nvidia-smi lists no other fleet process; 5 /debug/profile
           traces of 200 ms in a row on the owner's debug port (all within
           the load), each capture's kernel
           counts printed, every one naming way_scan_kernel<false>,
           slab_apply_kernel and sketch_update_kernel, and its /metrics
           counts their launches and the items its shm rings carried;
           GET /metrics?fleet=1 on the master counts the calls the clients
           sent, ratelimit_native_available reads 1 on every member and the
           build gauges name the card for the owner only. A second wave
           without shared keys: SIGKILL a worker mid-wave; the master
           restarts it, the owner detaches its rings, and the connections
           whose calls failed are at most the killed worker's, all at the
           kill (a thread whose redial reached the dying worker's listener
           fails twice on its one connection).
           SIGTERM to the master: exit 0, no shm segment of its workers
           (the restarted one too) left, and the
           owner's drain snapshot restores into a fresh engine on the card
           with each shared key's counter its calls admitted plus refused.
           (b) an external sidecar_cmd, and a cuda-sidecar master of four
           workers against it with SHM_RINGS=false and a concurrency rule
           (acquire only, cap 4) on 16 more shared keys: both rules exact,
           the owner's trace names way_scan_kernel<true> once the guard has
           flipped. (c) the same load on the single-process Runner and on
           one cuda-sidecar worker against (b)'s owner (rings attached, its
           segments gone at its exit), beside (a)'s fleet: requests/s,
           p50/p99 per call, the busy share of the process holding the
           card, the mean batch per launch; printed,
           not claimed. (d) a cuda-sidecar Runner with LEASE_ENABLED true
           and false, each against its own owner served in this process on
           one fake clock: a sequential stream on phase 12's hot keys
           answered byte for byte alike, the lease arm's owner launching
           less and holding liabilities. Prints one "fleet:" JSON line with
           the card's name and power limit.
14. cluster warm-standby replication and the partitioned cluster at the
           default deployment (2^22 slots, W = 128, the production sketch,
           TPU_BATCH_WINDOW=200us), every owner a sidecar_cmd child
           process on the card with its own slab, the load phase 13's
           client processes. (a) a primary (--role primary) and a standby
           (--role standby) with SIDECAR_ADDRS=P,S and REPL_INTERVAL_MS=100
           boot together; a cuda-sidecar master of four workers with the
           same SIDECAR_ADDRS (socket RPC, every frame epoch-fenced) takes
           6 s of load: no call fails, each shared key admits exactly
           min(4, calls); the lag at both owners, delta frames a second,
           bytes a frame and the ship loop's export drain and diff ms an
           interval are read from their /metrics, beside phase 13 (b)'s
           calls/s. The load stops, three intervals pass, P takes SIGTERM
           (its drain snapshot is its last table) and a zero-hit write
           promotes S to epoch 2: S's drain snapshot equals reconcile_rows
           of P's, bit for bit, but for the probe key's row. A fresh pair
           and frontend take load (each shared call's answer time logged)
           and P is SIGKILLed 4 s in: no call fails; each shared key (its limit
           crossed after the kill) admits at least min(limit, calls) and
           overshoots by at most its admissions in the window the last
           ship could have missed plus its calls P took but never
           answered; the kill to S's first answer and S's
           promotion ms. The old P boots again at epoch 1 and answers a
           write stamped with epoch 2 with STATUS_STALE_EPOCH, counted in
           repl.stale_epoch_rejected. (b) two partition owners
           (PARTITIONS=2, PARTITION_ROUTE_SETS=256, no standbys) and a
           third holding the three-partition map boot together; a
           cuda-sidecar Runner with PARTITIONS=2 in this process and a
           memory Runner on one fake clock answer phase 9's stream (hour
           rules) byte for byte alike; then load through the partitioned
           Runner and ReshardCoordinator 2 -> 3 (RESHARD_RATE_LIMIT_MB_S at
           its default) 3 s in: no call fails, sets move, the router
           adopts epoch 2, each shared key's counter lies in [n - m, n],
           m its own calls answered after the flip began and started
           before the drain ended; rows and bytes moved, the reshard's wall
           time and each merging owner's state-lock hold. Every owner's
           /metrics counts way_scan, slab_apply and sketch_update launches
           (the promoted standbys and the third partition too), and each
           owner's map epoch and repl epoch are printed. Each arm's owners
           start booting once the arm before has read its load's figures.
           Prints one "cluster:" JSON line with the card's name and power
           limit.
15. federation quota federation and the live fault injector at the default
           deployment with the dispatch loop (2^22 slots, W = 128, the
           production sketch, TPU_BATCH_WINDOW=200us), two clusters: east a
           sidecar_cmd owner child on the card, west a Runner in this
           process, both FED_ENABLED with FED_SETTLE_INTERVAL_MS=50 and
           FED_SHARE_TTL_MS=20000 (longer than any grant's last renewal in
           the outage is from west's stop, so none lapses and fences west
           before it; east borrows nothing, and nothing dials west's
           entry), west with FAILURE_MODE_DENY=deny and a
           SLAB_SNAPSHOT_DIR; 16 shared keys (8 homed at each cluster:
           members sort east, west, so east homes even fingerprints),
           limit 50 an hour. (a) 1024 of phase
           9's v3 calls through west and a FED_ENABLED=false Runner on one
           fake clock: byte-identical, one launch of the way scan, the
           apply and the fused sketch update a call at west, /metrics with
           the ratelimit_fed_* families, the ladder's counters 0. (b) POST
           /debug/faults dispatch.launch:error:1 to west; 13 rounds of 8
           sequential calls on each shared key (4 of the east-homed keys
           join for the last 4 rounds only, keeping unspent shares), 0.2 s
           apart: every
           call answered, no launch on the card; west-homed keys admit
           their first 50 from west's home budget; east-homed keys are
           refused until a pump brings east's grant, then admit from the
           share, the fully driven ones exactly 50; no key past 50; every
           call reaches the ladder (fallback.deny counts each), the share
           rung serves the OK answers and exactly their journeys carry
           fed; GET /debug/faults shows the rule firing once a call; both
           clusters' /debug/federation list the grants and settles, and
           east's outstanding tokens equal west's unsettled ones. (c)
           fed.exchange:corrupt:1:times=1 on west (POST /debug/faults) and
           fed.apply:drop:1:times=1 on east (admin_set_faults,
           OP_FAULTS_SET): each fires once, west resyncs twice, no share
           past its limit. (d) the empty spec at both: one call on each
           shared key answers OK from the card, one launch of each kernel a
           call, the ladder untouched. (e) west stops (slab.snap, fed.snap);
           east reclaims, past the TTL, exactly the unsettled tokens of
           fed.snap's share rows, one reclaim a share; a fresh west (its
           clock advanced as long) restores the live rows (the home rows:
           restore_fed_shares), its slab rows for them read back from the
           card at or above their floors, and with the launches failed
           again its first exchange is the handshake snapshot (one resync,
           east's fence adopted, no stale settle at east). Prints one
           "federation:" JSON line with the card's name and power limit.
16. chaos   the chaos campaign engine and the operator tools
           (api_ratelimit_tpu_torch/chaos/, tools/). (a) seeds 1-4 at the
           default CampaignConfig (120 steps, every nemesis class) on the
           CPU, then on the card with every launch counter set to 0 just
           before: each verdict ok and its canonical JSON byte-identical to
           the CPU run; way_scan_kernel<false> per item, slab_apply_kernel
           and the promote pass's way_scan_kernel<true> each launched, the
           sketch update never (hotkey_lanes 0); replay_matches on the card
           for each seed; on seed 3's kill-only timeline the full bound ok
           and the crash term weakened caught, blamed on crash and ddmin'd
           on the card to at most 3 actions with an owner kill; seconds a
           campaign on the card and on the CPU. (b) as processes on the
           card: hotpath_profile's default arm and --dispatch (the
           [hotpath] line, the pstats table; the owner thread's table
           names dispatch.py _run and no request-thread call),
           --slab-split at 2^22 rows, W = 128, b = 8192 (gather_ns,
           scan_ns and scatter_ns, each p50 inside the bucket the printed
           /metrics histograms put half their 30 samples in), and
           snapshot_inspect on phase 11's drain slab.snap: its restorable
           rows equal the rows phase 11 restored. Prints one "chaos:" JSON
           line with the card's name and power limit.
17. report per-kernel median device times (torch.profiler) and CUDA-event
           call times, bounds and launches as one JSON line (the sketch
           update over a real served step's candidates; the way scan, with
           the shipped routing, also at the decided phase's b = 2^20 over
           its table, each of its forms timed beside it on the same
           operands with its activities one by one; the three
           decision kernels at the decided phase's b = 2^20, sel and chain
           at the tool's; the multi-algorithm way scan on the served mix's
           table and the decided multi step's, each beside the fixed
           instantiation on the same operands, and the decide kernel on
           that step's before/after); the standalone sketch scan, now on no
           path, on a line of its own, with the parent's two-kernel sketch
           update (scan kernel + torch phases) timed beside the fused
           kernel; the process, observability, warm restart and tiers
           phases' lines, the fleet's, the cluster's, the federation's and
           the chaos phase's, the card's name
           and power limit, then the ok line.

Exits non-zero, printing no result, without a CUDA device. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import http.client
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
BUCKETS = (128, 1024, 8192, 65536)
N_SLOTS = 1 << 22  # the TPU_SLAB_SLOTS default: 128 MiB of rows
NOW0 = 1_700_000_000
HOTKEY_LANES, HOTKEY_K = 128, 16  # the settings defaults
SOURCES = {
    "way_scan": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "way_scan_multi": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "slab_apply": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "sketch_scan": "api_ratelimit_tpu_torch/csrc/sketch_kernels.cu",
    "sketch_update": "api_ratelimit_tpu_torch/csrc/sketch_kernels.cu",
    "slab_apply_decide": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "slab_apply_lean": "api_ratelimit_tpu_torch/csrc/slab_kernels.cu",
    "decide": "api_ratelimit_tpu_torch/csrc/decide_kernels.cu",
    "sel": "api_ratelimit_tpu_torch/csrc/select_kernels.cu",
    "chain": "api_ratelimit_tpu_torch/csrc/select_kernels.cu",
}
REPLACES = {
    "way_scan": "api_ratelimit_tpu/ops/pallas_slab.py:312",
    # the Pallas scan is fixed-window only: its multi-algorithm form is the
    # XLA twin's _scan_ways(multi_algo=True), api_ratelimit_tpu/ops/slab.py:278
    "way_scan_multi": "api_ratelimit_tpu/ops/pallas_slab.py:312",
    "slab_apply": "api_ratelimit_tpu/ops/pallas_slab.py:371",
    "sketch_scan": "api_ratelimit_tpu/ops/sketch.py:148",
    "sketch_update": "api_ratelimit_tpu/ops/sketch.py:148",
    "slab_apply_decide": "api_ratelimit_tpu/ops/pallas_slab.py:371",
    "slab_apply_lean": "api_ratelimit_tpu/ops/pallas_slab.py:371",
    "decide": "api_ratelimit_tpu/ops/pallas_decide.py:120",
    "sel": "tools/microbench_compare_paths.py:83",
    "chain": "tools/microbench_compare_paths.py:110",
}
NEAR_RATIOS = (0.0, 0.8, 1.0)
# the chaos campaign's owner engine (chaos/harness.py): 32 rows, W = 2, one
# bucket of 16; phase 2 holds its kernels at that geometry
CHAOS_SLOTS, CHAOS_WAYS, CHAOS_BATCH = 32, 2, 16
CHAOS_PARITY_REPS = 16
# the apply kernel's tile-scan parity: sizes around its 512-item tiles and
# the two paths' buckets, and the fresh 2^20 seeds run in full and lean form
APPLY_SIZES = (1, 127, 1024, 65536, (1 << 20) - 37, 1 << 20)
APPLY_REPEATS = 20
APPLY_FORM_ARGS = {
    "after": ("slab_apply", {}),
    "after+weight": ("slab_apply", {"weight": True}),
    "decided": ("slab_apply_decide", {"decide": True, "near_ratio": 0.8}),
    "lean": ("slab_apply_lean", {"decide": True, "lean": True, "near_ratio": 0.8}),
}
APPLY_FORMS = tuple(APPLY_FORM_ARGS)
# the fused sketch update's parity: one item, a batch that is not a multiple
# of its 512-item blocks, the buckets and the decided batch
SKETCH_UPDATE_SIZES = (1, 1000, *BUCKETS, 1 << 20)
# (lanes, ways) beyond the served geometry, at the top bucket: planes too large
# to stage in shared memory, and 4096 one-way sets (shared memory by opt-in)
SKETCH_UPDATE_WIDE = ((8192, 4), (4096, 1))
# the decided phase: bench.py bench_engine_zipf's shapes on the card
DECIDED_SLOTS = 1 << 23  # 256 MiB of rows
DECIDED_BATCH = 1 << 20
DECIDED_KEYS = 10_000_000
DECIDED_BLOCKS = 33  # one warm-up launch + 32 timed
DECIDED_LIMIT = 100
DECIDED_WAYS = 128
PLAIN_TWIN_BLOCKS = 4  # the plain way scan gathers (2^20, 128, 8) int32 sets: 4 GiB
# the compare/select micro-benchmark: the tool's default batch
SELECT_BATCH = 1 << 20
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
SELECT_EDGES = (
    INT_MIN, INT_MIN + 1, INT_MAX, INT_MAX - 1, 0, 1, -1, 3, -5,
    1 << 30, (1 << 30) + 1, (1 << 30) - 1, (1 << 30) + 3,
    1 << 29, (1 << 29) + 1, (1 << 29) - 1, (1 << 29) + 3, -(1 << 30),
)
# the windowed phase: the reference's default deployment with
# TPU_BATCH_WINDOW=200us (README.md's example value)
WINDOW_S = 0.0002
# request counts cut so the script keeps its ~1 minute of command time
SERIAL_SUBMITS = 100
CLIENT_THREADS = 32
WINDOWED_REQUESTS = 1 << 13
DIRECT_REQUESTS = 1 << 9  # direct mode serializes every request: fewer


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def log(*args) -> None:
    print(*args, flush=True)


def i32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


def fingerprints(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """splitmix64 of key ids -> (fp_lo, fp_hi) uint32 halves."""
    x = keys.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)


def adversarial_table(rng, n_slots: int, now: int, lo, hi, ways: int = 1) -> np.ndarray:
    """Dead, never-written, window-ended and live rows; 30% of counts drawn
    up to 2^32; half the batch's own keys stored in a way of their set."""
    t = np.empty((n_slots, 8), np.uint32)
    t[:, 0] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    t[:, 1] = rng.integers(0, 1 << 32, n_slots, dtype=np.uint64)
    big = rng.random(n_slots) < 0.3
    t[:, 2] = np.where(big, rng.integers(0, 1 << 32, n_slots, dtype=np.uint64), rng.integers(0, 50, n_slots))
    div = rng.choice(np.array([1, 60, 3600], np.int64), n_slots)
    t[:, 3] = (now // div) * div - div * rng.integers(0, 2, n_slots)
    t[:, 4] = now + rng.integers(-5, 100, n_slots)
    t[rng.random(n_slots) < 0.2, 4] = 0
    t[:, 5] = div
    t[:, 6:] = 0
    k = len(lo) // 2
    n_sets = n_slots // ways
    idx = (lo[:k].astype(np.int64) & (n_sets - 1)) * ways + rng.integers(0, ways, k)
    t[idx, 0], t[idx, 1] = lo[:k], hi[:k]
    return t


def scan_inputs(rng, b: int, n_slots: int, ways: int, now: int, dev, crowd_share: float = 0.25):
    """A batch with its own keys in the table, a share of it (a quarter)
    contending for one set, and zero (padding) fingerprints at the tail."""
    lo, hi = fingerprints(rng.integers(0, 1 << 40, b))
    n_sets = n_slots // ways
    crowd = rng.random(b) < crowd_share
    lo[crowd] = (lo[crowd] & ~np.uint32(n_sets - 1)) | np.uint32(7 % n_sets)
    lo[-b // 16 :] = 0
    hi[-b // 16 :] = 0
    table = adversarial_table(rng, n_slots, now, lo, hi, ways)
    return i32(table, dev), i32(lo, dev), i32(hi, dev)


def apply_inputs(rng, b: int, now: int, dev):
    """Slot-sorted apply operands: runs of one key up to 3000 long (so
    segments cross the kernel's 512-item tiles), hits up to 2^31 (sums
    wrap), stored rows that match in and out of the current window, and
    hits == 0 padding at the tail."""
    runs = rng.integers(1, 3000 if b > 1024 else 40, b)
    n_runs = int(np.searchsorted(np.cumsum(runs), b)) + 1  # the runs that fill b items
    keys = np.repeat(np.arange(n_runs), runs[:n_runs])[:b]
    hits = np.where(rng.random(b) < 0.05, rng.integers(0, 1 << 31, b), rng.integers(1, 4, b)).astype(np.uint32)
    hits[-b // 16 :] = 0
    return apply_batch(rng, keys, hits, now, dev)


def apply_batch(rng, keys: np.ndarray, hits: np.ndarray, now: int, dev):
    """The apply's operands for slot-sorted key ids (a segment starts where
    the id changes) and their hits: mixed dividers and jitter, stored rows
    that match in and out of the current window."""
    b = keys.size
    lo, hi = fingerprints(keys)
    div = rng.choice(np.array([0, 1, 60, 3600], np.int32), b)
    jit = rng.integers(0, 30, b).astype(np.int32)
    seg_start = np.concatenate([[True], (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
    st = adversarial_table(rng, b, now, lo, hi)
    same = rng.random(b) < 0.7
    st[same, 0], st[same, 1] = lo[same], hi[same]
    return (
        i32(lo, dev), i32(hi, dev), i32(hits, dev), i32(div, dev), i32(jit, dev),
        torch.from_numpy(seg_start).to(dev), i32(st, dev),
    )


def scan_edge_inputs(rng, kind: str, b: int, now: int, dev):
    """Batches aimed at the apply's chained tile scan. "one_key": a single
    segment across every tile, hits up to 2^31 (the sum wraps inside it);
    "wraps": hits up to 2^16, so 2^20 items wrap the running sum ~8 times,
    with a segment starting right after every wrap besides runs of up to
    3000; "zero_hits": runs of keys with no hits at all."""
    if kind == "one_key":
        keys = np.zeros(b, np.int64)
        hits = np.where(rng.random(b) < 0.05, rng.integers(0, 1 << 31, b), rng.integers(1, 4, b))
    elif kind == "wraps":
        hits = rng.integers(0, 1 << 16, b, dtype=np.uint64)
        incl = np.cumsum(hits)
        wrapped = np.concatenate([[False], (incl[:-1] >> np.uint64(32)) != ((incl[:-1] - hits[:-1]) >> np.uint64(32))])
        check(int(wrapped.sum()) >= 2, "the wrap batch does not wrap 2^32 twice")
        starts = wrapped | (rng.random(b) < 1 / 1500)
        starts[0] = True
        keys = np.cumsum(starts) - 1
    elif kind == "zero_hits":
        runs = rng.integers(1, 3000, b)
        n_runs = int(np.searchsorted(np.cumsum(runs), b)) + 1
        keys = np.repeat(np.arange(n_runs), runs[:n_runs])[:b]
        hits = np.zeros(b)
    else:
        raise ValueError(kind)
    return apply_batch(rng, keys, hits.astype(np.uint32), now, dev)


def decide_limits(rng, before: np.ndarray, after: np.ndarray) -> np.ndarray:
    """uint32 limits that put the items of an apply batch on every branch
    of the decision: under the near threshold, between it and the limit,
    crossing it within the item, all over (before >= limit), and every
    97th at the f32 edge, within 128 of 2^32, where the threshold's
    float-to-unsigned convert saturates."""
    b = before.size
    before, after = before.astype(np.uint64), after.astype(np.uint64)
    branch = rng.integers(0, 4, b)
    limit = np.select(
        [branch == 0, branch == 1, branch == 2],
        [after * 2 + 10, after + rng.integers(0, 4, b).astype(np.uint64), (before + after) // 2],
        before - np.minimum(before, rng.integers(0, 4, b).astype(np.uint64)),
    )
    limit = np.minimum(limit, (1 << 32) - 256)
    limit[::97] = (1 << 32) - rng.integers(1, 128, limit[::97].size).astype(np.uint64)
    return limit.astype(np.uint32)


def decide_inputs(M, rng, b: int, now: int, dev):
    """apply_inputs plus limits from decide_limits over the plain apply's
    before/after: (apply operands, int32 limits, (before, after, hits,
    limits, dividers) for the standalone decide)."""
    ops = apply_inputs(rng, b, now, dev)
    before, after = M.K.slab_apply_plain(*ops, now)[:2]
    host = lambda t: t.cpu().numpy().view(np.uint32)  # noqa: E731
    limit = i32(decide_limits(rng, host(before), host(after)), dev)
    return ops, limit, (before, after, ops[2], limit, ops[3])


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, "kernel output shape/dtype differs")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


PRIMER = "spin_kernel"  # torch.cuda._sleep's kernel


def prime_trace() -> None:
    """Open a trace with a few empty kernels and wait for them. The tracer
    has dropped the first activities of a trace on the card (the operand's
    H2D copy and the way scan of a profiled step; 1-2 of 20 launches in
    device_ms), so those are the primer's; device_activities leaves them
    out."""
    for _ in range(8):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def device_activities(prof) -> list:
    """(name, microseconds) of every kernel and copy the card ran inside a
    torch.profiler trace, in order of their start, without the primer's."""
    from torch.autograd import DeviceType

    events = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA and PRIMER not in e.name),
        key=lambda e: e.time_range.start,
    )
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the kernels and copies it runs on the card,
    each at its median duration over `iters` synchronized calls after a
    warm-up (torch.profiler), summed. Every call runs the same activities,
    so an activity name seen n times in the trace runs round(n / iters)
    times a call, and a trace that drops a record (prime_trace) still gives
    the median. The host time of the Python wrapper around a launch is not
    in it: call_ms measures that."""
    return summed_ms(*traced_calls(fn, iters))


def summed_ms(per_call: dict, by_name: dict) -> float:
    """traced_calls' activities summed at their median durations, in ms."""
    return sum(n * float(np.median(by_name[name])) for name, n in per_call.items()) / 1e3


def activities_per_call(fn, iters: int = 20) -> int:
    """The device activities one call runs, counted as device_ms counts
    them, so a dropped record does not change the count."""
    return sum(traced_calls(fn, iters)[0].values())


def traced_calls(fn, iters: int) -> tuple[dict, dict]:
    """torch.profiler over `iters` synchronized calls of fn after a warm-up:
    ({activity name: runs a call}, {activity name: [microseconds]})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prime_trace()
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
        by_name: dict = {}
        for name, us in device_activities(prof):
            by_name.setdefault(name, []).append(us)
        per_call = {name: round(len(durations) / iters) for name, durations in by_name.items()}
        if any(per_call.values()):
            break
        # the tracer has come back empty now and then: trace again
        log(f"device_ms: trace {attempt} held no device activity that recurs in each of {iters} calls")
    check(any(per_call.values()), f"no device activity recurs in each of {iters} calls")
    for name, n in per_call.items():
        if len(by_name[name]) != n * iters:
            log(f"device_ms: {name[:60]} traced {len(by_name[name])} times in {iters} calls")
    return per_call, by_name


def call_ms(fn, iters: int = 20) -> float:
    """Median milliseconds of one call by a CUDA-event pair around it,
    after a warm-up: the device time plus whatever host time of the call
    (the Python wrapper, launch overhead) keeps the card waiting."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples))


@contextlib.contextmanager
def plain_kernels(M):
    """Route the slab step (ops/slab.py) and the sketch update
    (ops/sketch.py), which call the wrappers by the names they imported,
    through the plain versions even for CUDA tensors: the reference engine
    of the engine phase. Fails unless the block launched no kernel, so the
    reference can never be the kernels."""
    K, S, SKK, SKT = M.K, M.S, M.SKK, M.SKT
    saved = S.way_scan, S.slab_apply, SKT.sketch_update_fused
    before = dict(K.LAUNCHES)
    S.way_scan, S.slab_apply = K.way_scan_plain, K.slab_apply_plain
    SKT.sketch_update_fused = SKK.sketch_update_plain
    try:
        yield
    finally:
        S.way_scan, S.slab_apply, SKT.sketch_update_fused = saved
    check(K.LAUNCHES == before, f"the plain engine launched kernels: {before} -> {K.LAUNCHES}")


def sketch_planes(rng, lanes: int, ways: int) -> np.ndarray:
    """Adversarial sketch planes: empty lanes (count 0, fp 0/0), stale tags
    under count 0, an occupied 0/0 tag, count ties, counts >= 2^31
    (unoccupied when read signed) and random occupied rows."""
    p = np.zeros((3, lanes), np.uint32)
    # each lane's fp_lo names its own set, so resident keys can match
    n_sets = lanes // ways
    own_set = (np.arange(lanes) // ways).astype(np.uint64)
    p[0] = (rng.integers(0, 1 << 32, lanes, dtype=np.uint64) & ~np.uint64(n_sets - 1)) | own_set
    p[1] = rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
    kind = rng.integers(0, 5, lanes)
    p[2] = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [0, rng.integers(1, 4, lanes), rng.integers(1 << 31, 1 << 32, lanes, dtype=np.uint64), 7],
        rng.integers(1, 1000, lanes),
    )
    empty = (kind == 0) & (rng.random(lanes) < 0.5)
    p[0][empty] = 0
    p[1][empty] = 0
    p[:2, lanes // 3] = 0
    p[2, lanes // 3] = 5
    return p


def sketch_queries(rng, planes: np.ndarray, b: int):
    """Half resident fingerprints, half misses, fp-0 padding at the tail."""
    pick = rng.integers(0, planes.shape[1], b)
    lo, hi = planes[0, pick].copy(), planes[1, pick].copy()
    miss = rng.random(b) < 0.5
    lo[miss] = rng.integers(0, 1 << 32, int(miss.sum()), dtype=np.uint64)
    lo[-b // 8 :] = 0
    hi[-b // 8 :] = 0
    return lo, hi


def sketch_update_inputs(rng, lanes: int, ways: int, b: int):
    """One launch's sketch update operands over the adversarial planes of
    sketch_planes: a batch of runs of distinct keys (resident fingerprints,
    occupied or not, and new ones), each run's last item the candidate (a
    tenth of the runs have none); weights small (ties), up to 2^32 - 1 and
    0 (a wrapped segment sum). From b >= 8 on, set 0 is forced: its lanes
    occupied, its victim lane holding the first candidate's key (the
    matched lane is the victim), and two new keys tied on the top weight
    and fp_hi. Returns (planes, fp_lo, fp_hi, weight) as uint32 numpy and
    cand as bool numpy."""
    planes = sketch_planes(rng, lanes, ways)
    n_keys = max(1, b // 3)
    pick = rng.integers(0, lanes, n_keys)
    lo, hi = planes[0, pick].copy(), planes[1, pick].copy()
    new = rng.random(n_keys) < 0.5
    lo[new] = rng.integers(0, 1 << 32, int(new.sum()), dtype=np.uint64)
    hi[new] = rng.integers(0, 1 << 32, int(new.sum()), dtype=np.uint64)
    _, first = np.unique((lo.astype(np.uint64) << np.uint64(32)) | hi, return_index=True)
    lo, hi = lo[np.sort(first)], hi[np.sort(first)]
    item_key = np.sort(rng.integers(0, lo.size, b))
    lo, hi = lo[item_key], hi[item_key]
    cand = np.r_[item_key[1:] != item_key[:-1], True] & (rng.random(b) < 0.9)
    weight = np.select(
        [rng.random(b) < 0.1, rng.random(b) < 0.2],
        [np.uint64(0), rng.integers(1 << 31, 1 << 32, b, dtype=np.uint64)],
        rng.integers(1, 4, b, dtype=np.uint64),
    ).astype(np.uint32)
    if b >= 8:
        n_sets = lanes // ways
        planes[2, :ways] = rng.integers(10, 1000, ways)
        victim = 1 % ways
        planes[2, victim] = 3
        new_lo = (rng.integers(1 << 20, 1 << 31, 2, dtype=np.uint64) * np.uint64(n_sets)) & np.uint64(0xFFFFFFFF)
        lo[:3] = [planes[0, victim], new_lo[0], new_lo[1]]
        hi[:3] = [planes[1, victim], 0xFFFFFFF0, 0xFFFFFFF0]
        weight[:3] = [7, 0xFFFFFFFF, 0xFFFFFFFF]
        cand[:3] = True
        cand[3:][(lo[3:] == lo[0]) & (hi[3:] == hi[0])] = False  # the keys stay distinct
    return planes, lo, hi, weight, cand


def phase_parity(M, dev) -> dict:
    K, SKK = M.K, M.SKK
    rng = np.random.default_rng(1)
    n_slots = N_SLOTS
    err = dict.fromkeys(SOURCES, 0)
    for ways in (4, 128):
        for b in BUCKETS:
            table, lo, hi = scan_inputs(rng, b, n_slots, ways, NOW0, dev)
            want = way_scan_forms_parity(M, table, lo, hi, NOW0, ways, f"b={b} W={ways}", err)
            check(bool(want[1].any()) and not bool(want[1].all()), "scan parity batch lacks matches or misses")
        # one set holding over half of a 2^20 batch
        table, lo, hi = scan_inputs(rng, DECIDED_BATCH, n_slots, ways, NOW0, dev, crowd_share=0.6)
        check(int((lo & (n_slots // ways - 1) == 7 % (n_slots // ways)).sum()) * 2 > DECIDED_BATCH, "the skewed batch's crowd is under half")
        way_scan_forms_parity(M, table, lo, hi, NOW0, ways, f"skewed b=2^20 W={ways}", err)
        del table, lo, hi
    chaos_geometry_parity(M, rng, dev, err)
    for b in BUCKETS:
        ops = apply_inputs(rng, b, NOW0, dev)
        got = K.slab_apply(*ops, NOW0)
        want = K.slab_apply_plain(*ops, NOW0)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"slab_apply differs from its plain version at b={b}")
        err["slab_apply"] = max(err["slab_apply"], e)
    for lanes in (128, 1024):
        for ways in (4, 128):
            for b in BUCKETS:
                planes = sketch_planes(rng, lanes, ways)
                lo, hi = sketch_queries(rng, planes, b)
                args = (i32(planes, dev), i32(lo, dev), i32(hi, dev), ways)
                got = SKK.sketch_scan(*args)
                want = SKK.sketch_scan_plain(*args)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                check(e == 0, f"sketch_scan differs from its plain version at b={b} W={ways} lanes={lanes}")
                check(bool(want[1].any()) and not bool(want[1].all()), "sketch parity batch lacks matches or misses")
                err["sketch_scan"] = max(err["sketch_scan"], e)
    sketch_cases = [(lanes, ways, b) for lanes in (128, 1024) for ways in (4, 128) for b in SKETCH_UPDATE_SIZES]
    sketch_cases += [(lanes, ways, BUCKETS[-1]) for lanes, ways in SKETCH_UPDATE_WIDE]
    for lanes, ways, b in sketch_cases:
        planes, lo, hi, weight, cand = sketch_update_inputs(rng, lanes, ways, b)
        args = (i32(planes, dev), i32(lo, dev), i32(hi, dev), i32(weight, dev), torch.from_numpy(cand).to(dev), ways)
        got = SKK.sketch_update_fused(*args)
        want = SKK.sketch_update_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err([got], [want])
        check(e == 0, f"sketch_update differs from its plain version at b={b} W={ways} lanes={lanes}")
        check(same(args[0], i32(planes, dev)), "sketch_update wrote its input planes")
        if b >= 8:
            victim = 1 % ways
            check(int(want[2, victim]) == 3 + 0xFFFFFFFF - (1 << 32), f"the forced victim lane was not taken at b={b} W={ways} lanes={lanes}")
        err["sketch_update"] = max(err["sketch_update"], e)
    D = M.D
    for b in BUCKETS:
        ops, limit, dec_ops = decide_inputs(M, rng, b, NOW0, dev)
        codes = K.slab_apply_plain(*ops, NOW0, s_limit=limit, decide=True, lean=True)[4]
        check(bool((codes == D.CODE_OK).any()) and bool((codes == D.CODE_OVER_LIMIT).any()), "decide parity batch lacks OK or OVER")
        for ratio in NEAR_RATIOS:
            for name, lean in (("slab_apply_decide", False), ("slab_apply_lean", True)):
                kw = {"s_limit": limit, "near_ratio": ratio, "decide": True, "lean": lean}
                got = K.slab_apply(*ops, NOW0, **kw)
                want = K.slab_apply_plain(*ops, NOW0, **kw)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                check(e == 0, f"{name} differs from its plain version at b={b} near_ratio={ratio}")
                err[name] = max(err[name], e)
            got = D.decide(*dec_ops, NOW0, ratio)
            want = D.decide_plain(*dec_ops, NOW0, ratio)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"decide differs from its plain version at b={b} near_ratio={ratio}")
            check(bool((want.throttle_millis != 0).any()) or ratio == 1.0, "decide parity batch has no paced item")
            err["decide"] = max(err["decide"], e)
    apply_scan_parity(M, dev, err)
    log(
        f"parity: bit-exact at buckets {BUCKETS}, W in (4, 128); sketch scan and update also at lanes in (128, 1024),"
        f" the update at b in {SKETCH_UPDATE_SIZES};"
        f" decided apply (full, lean) and decide at near_ratio in {NEAR_RATIOS}"
    )
    return err


def chaos_geometry_parity(M, rng, dev, err: dict) -> None:
    """The chaos campaign owner's geometry (phase 16: CHAOS_SLOTS rows,
    W = CHAOS_WAYS, the CHAOS_BATCH bucket), never on the card before: the
    way scan in both instantiations and both forms, the apply, and the
    victim tier's promote pass (slab_promote_rows, whose scan is the multi
    instantiation) against the same on the CPU, all bit-exact, over
    CHAOS_PARITY_REPS fresh tables."""
    K, S = M.K, M.S
    for rep in range(CHAOS_PARITY_REPS):
        for multi in (False, True):
            table, lo, hi = scan_inputs(rng, CHAOS_BATCH, CHAOS_SLOTS, CHAOS_WAYS, NOW0, dev)
            way_scan_forms_parity(M, table, lo, hi, NOW0, CHAOS_WAYS, f"b={CHAOS_BATCH} W={CHAOS_WAYS} over {CHAOS_SLOTS} rows", err, multi_algo=multi)
        ops = apply_inputs(rng, CHAOS_BATCH, NOW0, dev)
        e = max_abs_err(K.slab_apply(*ops, NOW0), K.slab_apply_plain(*ops, NOW0))
        check(e == 0, f"slab_apply differs from its plain version at b={CHAOS_BATCH}")
        err["slab_apply"] = max(err["slab_apply"], e)
        table = adversarial_table(rng, CHAOS_SLOTS, NOW0, *fingerprints(rng.integers(0, 1 << 40, CHAOS_BATCH)), CHAOS_WAYS)
        rows = promote_rows(rng, table, NOW0)
        card, host = S.slab_import_rows(table, device=dev), S.slab_import_rows(table, device="cpu")
        got = [t.cpu() for t in S.slab_promote_rows(card, rows, NOW0, ways=CHAOS_WAYS)]
        want = S.slab_promote_rows(host, rows, NOW0, ways=CHAOS_WAYS)
        torch.cuda.synchronize()
        check(same(got[0], want[0]) and same(got[1], want[1]), f"slab_promote_rows' landed/displaced differ from the CPU's (rep {rep})")
        check(same(card.table.cpu(), host.table), f"slab_promote_rows left other table bytes than the CPU's (rep {rep})")
        check(bool(want[0].any()) and not bool(want[0].all()), "the promote parity rows all landed or none did")
    log(
        f"chaos geometry parity: the way scan (both instantiations and forms), the apply and {CHAOS_PARITY_REPS}"
        f" promote passes bit-exact at b={CHAOS_BATCH}, W={CHAOS_WAYS}, {CHAOS_SLOTS} rows"
    )


def promote_rows(rng, table: np.ndarray, now: int) -> np.ndarray:
    """A victim tier's promote batch against `table`: copies of stored rows
    (fp matches) with older and newer windows and counts, fresh live rows,
    an expired row and zero padding lanes."""
    b = CHAOS_BATCH
    rows = np.zeros((b, 8), np.uint32)
    rows[:6] = table[rng.integers(0, table.shape[0], 6)]
    rows[:6, 2] = rng.integers(0, 100, 6)
    rows[:6, 3] = (now // 60) * 60 + 60 * rng.integers(-1, 2, 6)
    rows[:6, 4] = now + 120
    rows[:6, 5] = 60
    fresh = slice(6, 13)
    rows[fresh, 0], rows[fresh, 1] = fingerprints(rng.integers(1 << 41, 1 << 42, 7))
    rows[fresh, 2] = rng.integers(1, 100, 7)
    rows[fresh, 3] = (now // 60) * 60
    rows[fresh, 4] = now + 100
    rows[fresh, 5] = 60 | (rng.integers(0, 2, 7).astype(np.uint32) << 28)
    rows[13] = rows[6]
    rows[13, 0] ^= 1
    rows[13, 4] = now - 1  # expired: scratch row, not landed
    return rows


def way_scan_forms_parity(M, table, lo, hi, now: int, ways: int, label: str, err: dict, multi_algo: bool = False):
    """The way scan with the shipped routing and in each form on its own
    (set-major, per item) against its plain version, every output bit for
    bit, in the fixed-window or (multi_algo) the multi-algorithm
    instantiation; returns the plain version's outputs."""
    K = M.K
    name = "way_scan_multi" if multi_algo else "way_scan"
    want = K.way_scan_plain(table, lo, hi, now, ways, multi_algo=multi_algo)
    for form in (None, *K.WAY_SCAN_FORM_NAMES):
        got = K.way_scan(table, lo, hi, now, ways, form=form, multi_algo=multi_algo)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"{name} ({form or 'shipped routing'}) differs from its plain version on {label}")
        err[name] = max(err.get(name, 0), e)
    return want


def apply_forms(M, ops, now: int, limit, label: str, err: dict, forms=APPLY_FORMS) -> None:
    """Each named form of the apply kernel against its plain version on the
    same operands, every output bit for bit; the errors go into `err`
    under the form's launch-counter name."""
    K = M.K
    for form in forms:
        name, kw = APPLY_FORM_ARGS[form]
        if "decide" in kw:
            kw = {**kw, "s_limit": limit}
        got = K.slab_apply(*ops, now, **kw)
        want = K.slab_apply_plain(*ops, now, **kw)
        torch.cuda.synchronize()
        check(len(got) == len(want), f"apply {form} returned {len(got)} planes, its plain version {len(want)}")
        e = max_abs_err(got, want)
        check(e == 0, f"apply {form} differs from its plain version on {label}")
        err[name] = max(err[name], e)


def apply_scan_parity(M, dev, err: dict) -> None:
    """The apply kernel's chained tile scan against the plain version in
    every form (after, after with the sketch weight, decided, lean): at the
    sizes of APPLY_SIZES, on one segment across every tile of 2^20 items,
    on a batch whose sum wraps 2^32 several times with segments starting
    right after each wrap, and on all-zero hits; then the 2^20 full and
    lean forms on APPLY_REPEATS fresh seeds, since a look-back race would
    show only now and then."""
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    cases = [(f"b={b}", lambda b=b: apply_inputs(rng, b, NOW0, dev)) for b in APPLY_SIZES]
    cases += [
        (f"{kind} b=2^20", lambda kind=kind: scan_edge_inputs(rng, kind, DECIDED_BATCH, NOW0, dev))
        for kind in ("one_key", "wraps", "zero_hits")
    ]
    for label, make in cases:
        ops = make()
        before, after = (t.cpu().numpy().view(np.uint32) for t in M.K.slab_apply_plain(*ops, NOW0)[:2])
        limit = i32(decide_limits(rng, before, after), dev)
        apply_forms(M, ops, NOW0, limit, label, err)
    for seed in range(APPLY_REPEATS):
        r = np.random.default_rng(1000 + seed)
        ops, limit, _dec = decide_inputs(M, r, DECIDED_BATCH, NOW0, dev)
        apply_forms(M, ops, NOW0, limit, f"2^20 seed {1000 + seed}", err, forms=("decided", "lean"))
    log(
        f"apply scan parity: every form bit-exact at b in {APPLY_SIZES}, on {[c[0] for c in cases[len(APPLY_SIZES):]]},"
        f" and decided/lean on {APPLY_REPEATS} fresh 2^20 seeds ({time.perf_counter() - t0:.1f} s)"
    )


def zipf_keys(rng, n: int, n_keys: int = 1 << 20, s: float = 1.1) -> np.ndarray:
    cdf = np.cumsum(np.arange(1, n_keys + 1, dtype=np.float64) ** -s)
    return np.searchsorted(cdf, rng.random(n) * cdf[-1]).astype(np.int64)


def key_block(keys: np.ndarray) -> np.ndarray:
    """uint32[6, n] row block: fingerprint, 1 hit, per-key limit, divider
    (second/minute/hour by key id) and a small jitter."""
    block = np.empty((6, keys.size), np.uint32)
    block[0], block[1] = fingerprints(keys)
    block[2] = 1
    block[3] = np.array([5, 100, 1000], np.uint32)[keys % 3]
    block[4] = np.array([1, 60, 3600], np.uint32)[(keys // 3) % 3]
    block[5] = (keys % 7).astype(np.uint32)
    return block


def phase_engine(M, dev):
    """The kernel engine and the plain-kernel engine both carry the
    production sketch; a third, sketch-off engine (slice 1's step) shares
    their traffic and is timed against the kernel engine, alternating which
    goes first."""
    K, cuda_mod, utils = M.K, M.cuda_mod, M.utils
    rng = np.random.default_rng(2)
    clocks = [utils.FakeTimeSource(NOW0) for _ in range(3)]
    hot = {"hotkey_lanes": HOTKEY_LANES, "hotkey_k": HOTKEY_K}
    eng_k = cuda_mod.SlabDeviceEngine(clocks[0], n_slots=N_SLOTS, device=dev, **hot)
    eng_p = cuda_mod.SlabDeviceEngine(clocks[1], n_slots=N_SLOTS, device=dev, **hot)
    eng_off = cuda_mod.SlabDeviceEngine(clocks[2], n_slots=N_SLOTS, device=dev)
    check(eng_k.ways == 128, "engine did not default to 128 ways on cuda")
    check(eng_k.hotkeys_enabled and not eng_off.hotkeys_enabled, "sketch gate is off where it should be on")
    top = BUCKETS[-1]
    sizes = [top] * 32 + [b - b // 8 for b in BUCKETS[:-1]]
    launch_ms = {"sketch_on": [], "sketch_off": [], "plain": []}
    drained = []
    for i, n in enumerate(sizes):
        step = 61 if i % 8 == 7 else 1  # cross minute windows too
        for clock in clocks:
            clock.advance(step)
        block = key_block(zipf_keys(rng, n))
        timed = {}
        for name in (("sketch_on", "sketch_off") if i % 2 == 0 else ("sketch_off", "sketch_on")):
            eng = eng_k if name == "sketch_on" else eng_off
            torch.cuda.synchronize()
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            timed[name] = eng.submit_rows(block)
            t1 = time.perf_counter()
            ran = {k: K.LAUNCHES[k] - before[k] for k in before}
            want_ran = dict.fromkeys(before, 0) | {"way_scan": 1, "slab_apply": 1, "sketch_update": int(name == "sketch_on")}
            check(ran == want_ran, f"{name} engine launched {ran} at launch {i}, expected {want_ran}")
            if n == top:
                launch_ms[name].append((t1 - t0) * 1e3)
        t1 = time.perf_counter()
        with plain_kernels(M):
            want = eng_p.submit_rows(block)
        t2 = time.perf_counter()
        if n == top:
            launch_ms["plain"].append((t2 - t1) * 1e3)
        check(np.array_equal(timed["sketch_on"], want), f"engine afters differ at launch {i}")
        check(np.array_equal(timed["sketch_off"], want), f"sketch-off engine afters differ at launch {i}")
        check(np.array_equal(eng_k.export_sketch(), eng_p.export_sketch()), f"sketch planes differ at launch {i}")
        if i % 8 == 3:
            got_top = eng_k.drain_hotkeys()
            want_top = eng_p.drain_hotkeys()
            # one insert per sketch set per launch: at 128 lanes in one set
            # the sketch holds at most one new key per launch
            check(got_top == want_top and 0 < len(got_top) <= min(i + 1, HOTKEY_K), f"drained top-K differs at launch {i}")
            check(np.array_equal(eng_k.export_sketch(), eng_p.export_sketch()), "post-decay planes differ")
            drained.append(got_top[0][2])
    table = eng_k.export_tables()[0]
    check(np.array_equal(table, eng_p.export_tables()[0]), "engine tables differ")
    check(np.array_equal(table, eng_off.export_tables()[0]), "the sketch changed the slab")
    hk, hp, ho = eng_k.health_snapshot(), eng_p.health_snapshot(), eng_off.health_snapshot()
    check(hk == hp == ho, f"engine health differs: {hk} vs {hp} vs {ho}")
    check(hk["decisions"] == sum(sizes), "decision count is off")
    block = key_block(zipf_keys(rng, top))
    profiles = {name: profile_submit(eng, block) for name, eng in (("sketch_on", eng_k), ("sketch_off", eng_off))}
    sketch_share = sketch_activities(eng_k, eng_off, block)
    out = {
        "n_slots": N_SLOTS,
        "ways": eng_k.ways,
        "hotkey_lanes": HOTKEY_LANES,
        "launches": len(sizes),
        "step_ms_median_sketch_on": float(np.median(launch_ms["sketch_on"])),
        "step_ms_median_sketch_off": float(np.median(launch_ms["sketch_off"])),
        "step_ms_median_plain": float(np.median(launch_ms["plain"])),
        # device time of one profiled submit over the unprofiled median step
        "device_busy_share_sketch_on": profiles["sketch_on"]["device_ms"] / float(np.median(launch_ms["sketch_on"])),
        "device_busy_share_sketch_off": profiles["sketch_off"]["device_ms"] / float(np.median(launch_ms["sketch_off"])),
        "drained_top_counts": drained,
        "health": hk,
    }
    log("engine:", json.dumps(out))
    log("profile:", json.dumps(profiles))
    log("sketch share of a 65536-item submit (5 traced submits):", json.dumps(sketch_share))
    return eng_k


# the sketch's device activities in one served submit beyond the sketch-off
# step's: the fused kernel, its scratch memset and the few ops forming the
# candidate mask (ops/slab.py)
SKETCH_EXTRA_ACTIVITIES = 8


def sketch_activities(eng_on, eng_off, block: np.ndarray, iters: int = 5) -> dict:
    """The sketch's share of a 65536-item submit: the device activities a
    submit runs and their device ms (device_ms's counting over `iters`
    traced submits, so a dropped record changes nothing) with the sketch
    on and off, and the activities the sketch-on submit runs beyond the
    sketch-off one, by name. Fails if they are more than
    SKETCH_EXTRA_ACTIVITIES."""
    (on, on_us), (off, off_us) = (traced_calls(lambda e=e: e.submit_rows(block), iters) for e in (eng_on, eng_off))
    extra = collections.Counter(on) - collections.Counter(off)
    share = {
        "activities_on": sum(on.values()),
        "activities_off": sum(off.values()),
        "device_ms_on": summed_ms(on, on_us),
        "device_ms_off": summed_ms(off, off_us),
        "extra": sorted((name[:60], n) for name, n in extra.items()),
    }
    n_extra = sum(extra.values())
    check(n_extra <= SKETCH_EXTRA_ACTIVITIES, f"the sketch-on submit ran {n_extra} activities beyond the sketch-off one: {share['extra']}")
    return share


def profile_submit(engine, block: np.ndarray) -> dict:
    """profile_call over one warm submit_rows."""
    return profile_call(lambda: engine.submit_rows(block))


# the way scan's kernels by name: the per-item kernel, or the set-major
# form's grouping kernels and its scan
WAY_SCAN_KERNELS = ("way_scan", "set_count_kernel", "set_offset_kernel", "set_scatter_kernel")


def profile_call(fn) -> dict:
    """torch.profiler over one warm call of fn: host wall time (synchronized,
    profiler overhead included), the summed device time of its kernels and
    copies and of its host-to-device copies alone, the device's busy share
    of that wall time, the count of device activities, and the kernels and
    host ops that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime_trace()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        acts = device_activities(prof)
        if acts:
            break
        # the tracer has come back empty now and then: trace again
        log(f"profile_call: trace {attempt} held no device activity")
    check(bool(acts), "the profiler recorded no device activity")
    htod_ms = sum(us for name, us in acts if "HtoD" in name) / 1e3
    scan_acts = [us for name, us in acts if any(k in name for k in WAY_SCAN_KERNELS)]
    by_name: dict = {}
    for name, us in acts:
        ms, n = by_name.get(name[:60], (0.0, 0))
        by_name[name[:60]] = (ms + us / 1e3, n + 1)
    busy_ms = sum(us for _name, us in acts) / 1e3
    by_host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {
        "wall_ms": wall_ms,
        "device_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities": len(acts),
        "htod_ms": htod_ms,
        # the way scan's kernels (its memset is not told apart from others)
        "way_scan_ms": sum(scan_acts) / 1e3,
        "way_scan_kernels": len(scan_acts),
        "top_device_ms": sorted(([k, ms, n] for k, (ms, n) in by_name.items()), key=lambda r: -r[1])[:10],
        "top_host_ms": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in by_host],
    }


RULES = {
    "domain": "smoke",
    "descriptors": [
        {"key": "user", "rate_limit": {"unit": "minute", "requests_per_unit": 3}},
        {"key": "path", "value": "/login", "rate_limit": {"unit": "hour", "requests_per_unit": 100}},
    ],
}


class _Runtime:
    def snapshot(self):
        return self

    def keys(self):
        return ["config.smoke"]

    def get(self, key):
        return ""

    def add_update_callback(self, cb):
        pass


def http_call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        headers = {"Content-Type": "application/json"} if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def serve(device: str, bodies, defaults: bool = True, rules=None, clock_steps=None):
    """Start the port's server (W=128) and its debug server on ephemeral
    ports, POST `bodies` (each a /json body, or a (path, body) pair such as
    POST /release), flush the stats (the flush drains the sketch), GET
    /debug/hotkeys and /stats, stop both. defaults: the production
    settings (hotkeys on, host fast path); else slice 1's arm (sketch off,
    the trie walk into do_limit). rules: the config mapping (RULES if
    None); clock_steps: seconds to advance the clock before each body.
    Returns ([(status, body bytes)], hotkeys document bytes, stats
    document)."""
    from api_ratelimit_tpu_torch.backends.cuda import CudaRateLimitCache, HotkeyStats, SlabHealthStats
    from api_ratelimit_tpu_torch.config import ConfigDoc, build_config
    from api_ratelimit_tpu_torch.limiter import BaseRateLimiter
    from api_ratelimit_tpu_torch.server.http_server import HttpServer, new_debug_server
    from api_ratelimit_tpu_torch.service import RateLimitService
    from api_ratelimit_tpu_torch.stats import Store
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    clock = FakeTimeSource(NOW0)
    store = Store()
    root = store.scope("ratelimit")
    rules_scope = root.scope("rate_limit")
    cache = CudaRateLimitCache(
        BaseRateLimiter(clock), n_slots=N_SLOTS, ways=128, device=device,
        hotkey_lanes=HOTKEY_LANES if defaults else 0, hotkey_k=HOTKEY_K,
    )
    service = RateLimitService(
        _Runtime(), cache, root, clock,
        config_loader=lambda _files: build_config([ConfigDoc("smoke", rules or RULES)], rules_scope),
        host_fast_path=defaults,
    )
    store.add_stat_generator(SlabHealthStats(cache.engine, root.scope("slab")))
    store.add_stat_generator(HotkeyStats(cache.engine, root.scope("hotkeys")))
    server = HttpServer(service)
    debug = new_debug_server(store)
    debug.add_debug_endpoint("/debug/hotkeys", lambda: json.dumps(cache.hotkeys_debug(), indent=2))
    server.serve_background()
    debug.serve_background()
    try:
        out = []
        for i, body in enumerate(bodies):
            clock.advance(clock_steps[i] if clock_steps else 0)
            path, body = body if isinstance(body, tuple) else ("/json", body)
            out.append(http_call(server.port, "POST", path, body))
        store.flush()
        status, hotkeys = http_call(debug.port, "GET", "/debug/hotkeys")
        check(status == 200, f"/debug/hotkeys answered {status}")
        status, stats = http_call(debug.port, "GET", "/stats")
        check(status == 200, f"/stats answered {status}")
    finally:
        server.shutdown()
        debug.shutdown()
    return out, hotkeys, json.loads(stats)


def phase_serve(K) -> dict:
    def req(*descs):
        return json.dumps({"domain": "smoke", "descriptors": [{"entries": [{"key": k, "value": v}]} for k, v in descs]}).encode()

    bodies = [req(("user", "alice"), ("path", "/login")) for _ in range(5)] + [req(("user", "bob"))]
    bodies += [req(("path", "/login")) for _ in range(10)]
    want_statuses = [200, 200, 200, 429, 429, 200] + [200] * 10

    # slice 1's arm (sketch off, trie walk into do_limit): both slab
    # kernels launch, the sketch's never do
    K.reset_launch_counts()
    got1, _, stats1 = serve("cuda", bodies, defaults=False)
    launches1 = dict(K.LAUNCHES)
    want1, _, _ = serve("cpu", bodies, defaults=False)
    check(
        launches1["way_scan"] > 0 and launches1["slab_apply"] > 0
        and launches1["sketch_update"] == 0 and launches1["sketch_scan"] == 0,
        f"slice 1's arm launched {launches1}",
    )
    check([s for s, _ in got1] == want_statuses, f"unexpected slice-1 statuses {[s for s, _ in got1]}")
    check(got1 == want1, "card and CPU responses of slice 1's arm differ")
    check(stats1["ratelimit.slab.decisions"] == 21, f"unexpected slice-1 /stats {stats1}")

    # the production defaults: the main path, the source of the kernels
    # line's launch counts
    K.reset_launch_counts()
    got, hot_doc, stats = serve("cuda", bodies)
    launches = dict(K.LAUNCHES)
    forms = dict(K.WAY_SCAN_FORMS)
    check(sum(forms.values()) == launches["way_scan"], f"the served way scans ran as {forms}, against {launches['way_scan']} launches")
    want, want_doc, _ = serve("cpu", bodies)
    check(all(launches[k] > 0 for k in ("way_scan", "slab_apply", "sketch_update")), f"main path skipped a kernel: {launches}")
    # one sketch update a launch, and the standalone scan never
    check(
        launches["sketch_update"] == launches["way_scan"] == launches["slab_apply"] and launches["sketch_scan"] == 0,
        f"the served launches do not run one sketch update each: {launches}",
    )
    statuses = [s for s, _ in got]
    check(statuses == want_statuses, f"unexpected statuses {statuses}")
    check(got == want, "card and CPU responses differ")
    check(got == got1, "the fast path and slice 1's trie arm answer differently")
    first, fourth = json.loads(got[0][1]), json.loads(got[3][1])
    reset = f"{60 - NOW0 % 60}s"
    check(
        first["statuses"][0] == {"code": "OK", "currentLimit": {"requestsPerUnit": 3, "unit": "MINUTE"}, "limitRemaining": 2, "durationUntilReset": reset},
        f"unexpected first body {first}",
    )
    check(fourth["overallCode"] == "OVER_LIMIT" and fourth["statuses"][1]["limitRemaining"] == 96, f"unexpected fourth body {fourth}")
    check(hot_doc == want_doc, f"card and CPU /debug/hotkeys differ:\n{hot_doc!r}\n{want_doc!r}")
    doc = json.loads(hot_doc)
    check(doc["enabled"] and doc["drains"] == 1 and doc["lanes"] == HOTKEY_LANES, f"unexpected hotkeys document {doc}")
    # one insert per sketch set per launch: the first launch's two new keys
    # contend, so the loser's first hit is not counted
    head = doc["top"][0]
    check(head["key"] == "smoke_path_/login_" and head["count"] in (14, 15), f"hot descriptor not first: {doc['top']}")
    check(stats["ratelimit.hotkeys.drains"] == 2 and stats["ratelimit.slab.decisions"] == 21, f"unexpected /stats {stats}")
    log(f"serve: statuses {statuses}, slice-1 arm launches {launches1}, default launches {launches} (way scan forms {forms}), /debug/hotkeys top {doc['top'][:3]}")
    return launches


def zipf_ids(n_keys: int, batch: int, n_batches: int, seed: int = 0) -> np.ndarray:
    """bench.py zipf_ids: Zipf(1.1)-distributed key ids over an n_keys
    universe, as uint32[n_batches, batch]."""
    rng = np.random.RandomState(seed)
    ids = rng.zipf(1.1, size=batch * n_batches).astype(np.uint64) % n_keys
    return ids.reshape(n_batches, batch).astype(np.uint32)


def fmix32(x: np.ndarray) -> np.ndarray:
    """bench.py fmix32_np: the murmur3 finalizer, a bijection on uint32."""
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def decided_operand(ids: np.ndarray, now: int) -> np.ndarray:
    """bench_engine_zipf's expand() as a host operand uint32[7, b]: two
    fmix32 bijections of the id as the fingerprint (distinct ids never
    collide), 1 hit, limit 100, divider 1 (SECOND), no jitter; `now` and
    near_ratio 0.8 in the scalar row."""
    p = np.zeros((7, ids.size), np.uint32)
    p[0] = fmix32(ids)
    p[1] = fmix32(ids ^ np.uint32(0x9E3779B9))
    p[2] = 1
    p[3] = DECIDED_LIMIT
    p[4] = 1
    p[6, 0] = now
    p[6, 1] = np.float32(0.8).view(np.uint32)
    return p


def fmix32_dev(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on the card over int64 values in [0, 2^32). Each multiply by
    a 32-bit constant is split at bit 16, so no product exceeds 2^49 and
    nothing relies on how the card wraps an overflowing multiply; the
    result is masked to 32 bits."""

    def mul(v, c):
        return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF

    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def expand_ids(S, ids: torch.Tensor):
    """bench_step's expand() on the card: staged int32 ids (uint32 bits) ->
    the device SlabBatch of decided_operand's rows 0-5: fp_lo = fmix32(id),
    fp_hi = fmix32(id ^ 0x9E3779B9), 1 hit, limit 100, divider 1 (SECOND),
    no jitter."""
    x = ids.long() & 0xFFFFFFFF

    def as_i32(v):
        return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)

    ones = torch.ones_like(ids)
    return S.SlabBatch(
        as_i32(fmix32_dev(x)), as_i32(fmix32_dev(x ^ 0x9E3779B9)), ones,
        torch.full_like(ids, DECIDED_LIMIT), ones, torch.zeros_like(ids),
    )


def staged_step(M, state, ids: torch.Tensor, now: int):
    """bench_step on the port: expand staged ids on the card, run
    _slab_step_sorted with the lean fused apply, unsort the codes and pack
    the OVER bits on the card. Returns (uint8[b / 8] bits, int64[5] health),
    both on the card."""
    S, D = M.S, M.D
    _before, _after, d, order, health = S._slab_step_sorted(
        state, expand_ids(S, ids), now, 0.8, DECIDED_WAYS, lean=True
    )
    return D.packbits(S._unsort(d.code, order) == D.CODE_OVER_LIMIT), health


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two tensors of one dtype and shape (uint32 through
    its int32 view, which torch compares everywhere)."""
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def way_scan_graph_check(M, scan: dict, now: int, ways: int) -> None:
    """One way scan call over the decided stream's table and a staged block
    captured in a torch.cuda.CUDAGraph: the op makes no host
    synchronization and sizes its grids from shapes alone, so the replay's
    three outputs must equal an eager call's bit for bit."""
    K = M.K
    args = (scan["table"], scan["fp_lo"], scan["fp_hi"], now, ways)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.way_scan(*args)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    forms = dict(K.WAY_SCAN_FORMS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K.way_scan(*args)
    form = [f for f in K.WAY_SCAN_FORMS if K.WAY_SCAN_FORMS[f] != forms[f]]
    graph.replay()
    eager = K.way_scan(*args)
    torch.cuda.synchronize()
    check(all(same(a, b) for a, b in zip(captured, eager)), "the CUDA graph's way scan differs from the eager call")
    log(f"way scan in a CUDA graph: {form} form at b={args[1].shape[0]}, replay bit-exact to the eager call")
    del graph, captured, eager


def phase_decided(M, dev, scan_errs: dict) -> tuple[dict, dict, dict]:
    """The decided tier of bench_engine_zipf on the port (module docstring,
    phase 5). Returns (summary, launch counts for the kernels line: the
    lean apply's from the staged stream, the full apply's and decide's from
    the packed step; the way scan's operands at this shape: the stream's
    table, one staged block's fingerprints and its launches in the staged
    stream). The way scan's forms are held to the plain version on the
    stream's table, their errors going into scan_errs["way_scan"]."""
    K, S, D, O = M.K, M.S, M.D, M.O
    t_phase = time.perf_counter()
    ways, now, limit = DECIDED_WAYS, NOW0, DECIDED_LIMIT
    ids = zipf_ids(DECIDED_KEYS, DECIDED_BATCH, DECIDED_BLOCKS, seed=0)
    # bench_engine_zipf warms up on its last staged block, then replays the rest
    stream = np.concatenate([ids[-1:], ids[:-1]])
    ops = [decided_operand(block, now) for block in stream]
    t_gen = time.perf_counter() - t_phase

    def over_bits(codes):
        return D.packbits(codes == D.CODE_OVER_LIMIT)

    # a kernel table beside a plain-version table over the first blocks
    twin_k = S.make_slab(DECIDED_SLOTS, device=dev)
    twin_p = S.make_slab(DECIDED_SLOTS, device=dev)
    twin_bits = []
    for i in range(PLAIN_TWIN_BLOCKS):
        codes_k, health_k = S.slab_step_decided(twin_k, ops[i], ways=ways)
        with plain_kernels(M):
            codes_p, health_p = S.slab_step_decided(twin_p, ops[i], ways=ways)
        check(same(codes_k, codes_p), f"decided codes differ from the plain versions' at block {i}")
        check(same(health_k, health_p), f"decided health differs from the plain versions' at block {i}")
        twin_bits.append(over_bits(codes_k))
    check(same(twin_k.table, twin_p.table), "decided table differs from the plain versions' table")
    twin_bits = torch.cat(twin_bits).cpu().numpy()
    del twin_k, twin_p, codes_k, codes_p
    torch.cuda.empty_cache()
    t_twin = time.perf_counter() - t_phase - t_gen

    # the host-operand stream (slice 3's measure): one warm-up launch, then
    # 32 timed, each numpy operand uploaded inside the timed loop
    state_h = S.make_slab(DECIDED_SLOTS, device=dev)
    K.reset_launch_counts()
    codes, health = S.slab_step_decided(state_h, ops[0], ways=ways)
    healths_h, bits = [health], [over_bits(codes)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for op in ops[1:]:
        codes, health = S.slab_step_decided(state_h, op, ways=ways)
        healths_h.append(health)
        bits.append(over_bits(codes))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_bits = torch.cat(bits).cpu().numpy()
    t2 = time.perf_counter()
    host_launches = dict(K.LAUNCHES)
    n_launch = len(ops)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": n_launch, "slab_apply_lean": n_launch}
    check(host_launches == want, f"the host-operand stream launched {host_launches}, expected {want}")
    check(np.array_equal(host_bits[: twin_bits.size], twin_bits), "the stream's first blocks differ from the twin check's kernel table")
    del state_h, codes, bits
    torch.cuda.empty_cache()

    # the reference tier's quantity (bench.py bench_engine_zipf run_path):
    # the u32 ids staged on the card before timing and expanded there; the
    # launch chain timed to one synchronize, the bit readback apart
    staged = [torch.from_numpy(block.view(np.int32)).to(dev) for block in stream]
    first = expand_ids(S, staged[0])
    check(
        np.array_equal(first.fp_lo.cpu().numpy().view(np.uint32), ops[0][S.ROW_FP_LO])
        and np.array_equal(first.fp_hi.cpu().numpy().view(np.uint32), ops[0][S.ROW_FP_HI]),
        "the card's id expansion differs from decided_operand's fingerprints",
    )
    del first
    state = S.make_slab(DECIDED_SLOTS, device=dev)
    K.reset_launch_counts()
    bits_dev, health = staged_step(M, state, staged[0], now)
    healths, bits = [health], [bits_dev]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for block in staged[1:]:
        bits_dev, health = staged_step(M, state, block, now)
        healths.append(health)
        bits.append(bits_dev)
    torch.cuda.synchronize()
    s1 = time.perf_counter()
    staged_bits = torch.cat(bits).cpu().numpy()
    s2 = time.perf_counter()
    decided_launches = dict(K.LAUNCHES)
    decided_forms = dict(K.WAY_SCAN_FORMS)
    check(decided_launches == want, f"the staged stream launched {decided_launches}, expected {want}")
    # the way scan's rule sends this shape to the set-major form
    want_forms = {"set_major": n_launch, "per_item": 0}
    check(decided_forms == want_forms, f"the staged stream's way scans ran as {decided_forms}, expected {want_forms}")
    check(np.array_equal(staged_bits, host_bits), "the staged stream's OVER bits differ from the host-operand stream's")
    del bits

    rep = O.parity_report(stream.reshape(-1), np.unpackbits(staged_bits), limit=limit, code_over=1)
    h = [int(v) for v in torch.stack(healths).sum(dim=0).tolist()]
    check(h == [int(v) for v in torch.stack(healths_h).sum(dim=0).tolist()], "the staged stream's health differs from the host-operand stream's")
    ev_live, drops = h[S.HEALTH_EVICT_LIVE], h[S.HEALTH_DROPS]
    explained = rep["false_ok"] <= drops + ev_live * limit
    check(rep["false_over"] == 0, f"decided stream false_over {rep['false_over']}")
    check(explained, f"decided stream false_ok {rep['false_ok']} exceeds drops {drops} + {limit} x live evictions {ev_live}")
    live = S.live_slot_count(state.table, now)

    # the full decision: slab_step_packed on one 65536 block, its decision
    # rows against the standalone decide kernel, then against the plain
    # versions from a copy of the same table
    blk = decided_operand(ids[0, : BUCKETS[-1]], now)
    plain = S.SlabState(DECIDED_SLOTS, dev)
    plain.rows.copy_(state.rows)
    K.reset_launch_counts()
    out_k, health_k = S.slab_step_packed(state, blk, ways=ways)
    rows = out_k.view(torch.int32)
    op_dev = torch.from_numpy(blk.view(np.int32)).to(dev)
    order = rows[S.OUT_ORDER].long()
    sorted_in = [op_dev[r][order] for r in (S.ROW_HITS, S.ROW_LIMIT, S.ROW_DIVIDER)]
    fused = D.decide(rows[S.OUT_BEFORE], rows[S.OUT_AFTER], *sorted_in, now, 0.8)
    torch.cuda.synchronize()
    packed_launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": 1, "slab_apply_decide": 1, "decide": 1}
    check(packed_launches == want, f"the packed step launched {packed_launches}, expected {want}")
    check(same(torch.stack(list(fused)), rows[: S.OUT_BEFORE]), "the standalone decide disagrees with the fused apply")
    with plain_kernels(M):
        out_p, health_p = S.slab_step_packed(plain, blk, ways=ways)
    check(same(out_k, out_p) and same(health_k, health_p), "slab_step_packed differs from the plain versions")
    check(same(state.table, plain.table), "slab_step_packed's table differs from the plain versions'")
    codes = rows[S.OUT_CODE]
    check(bool((codes == D.CODE_OK).any()) and bool((codes == D.CODE_OVER_LIMIT).any()), "the packed block lacks OK or OVER")
    check(bool((rows[S.OUT_NEAR] != 0).any()), "the packed block has no near-limit item")

    blk = decided_operand(ids[1, : BUCKETS[-1]], now)
    res_k = S.slab_update_and_decide(state, blk, ways=ways)
    with plain_kernels(M):
        res_p = S.slab_update_and_decide(plain, blk, ways=ways)
    check(
        all(same(a, b) for a, b in zip((res_k.before, res_k.after, *res_k.decision, res_k.health),
                                      (res_p.before, res_p.after, *res_p.decision, res_p.health))),
        "slab_update_and_decide differs from the plain versions",
    )
    check(same(state.table, plain.table), "slab_update_and_decide's table differs from the plain versions'")
    del plain
    torch.cuda.empty_cache()

    # the staged step's profile: no operand upload, no host-to-device copy
    prof = profile_call(lambda: staged_step(M, state, staged[1], now))
    check(prof["htod_ms"] < 0.1, f"the staged step copied {prof['htod_ms']:.3f} ms host to device")
    timed = n_launch - 1
    out = {
        "n_slots": DECIDED_SLOTS,
        "ways": ways,
        "batch": DECIDED_BATCH,
        "launches_timed": timed,
        "decisions_per_s": timed * DECIDED_BATCH / (s1 - s0),
        "step_ms_mean": (s1 - s0) * 1e3 / timed,
        "readback_ms": (s2 - s1) * 1e3,
        "decisions_per_s_host_operand": timed * DECIDED_BATCH / (t2 - t0),
        "step_ms_mean_host_operand": (t1 - t0) * 1e3 / timed,
        "readback_ms_host_operand": (t2 - t1) * 1e3,
        "device_busy_share_profiled": prof["device_busy_share"],
        "device_busy_share_timed": timed * prof["device_ms"] / ((s1 - s0) * 1e3),
        "parity": {**rep, "explained": explained},
        "health": dict(zip(("evict_expired", "evict_window", "evict_live", "drops", "algo_resets"), h)),
        "live_slots": live,
        "occupancy": live / DECIDED_SLOTS,
        "plain_twin_blocks": PLAIN_TWIN_BLOCKS,
        "stream_s": t_gen,
        "twin_s": t_twin,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(
        f"decided: false_over {rep['false_over']} explained {str(explained).lower()} agreement {rep['agreement']}"
        f" decisions/s {out['decisions_per_s']:.0f} (staged ids) {out['decisions_per_s_host_operand']:.0f} (host operands)"
        f" phase {out['phase_s']:.1f} s"
    )
    log("decided:", json.dumps(out))
    log("decided launches:", json.dumps({
        "staged_stream": decided_launches, "staged_stream_way_scan_forms": decided_forms,
        "host_operand_stream": host_launches, "packed_step": packed_launches,
    }))
    log("decided profile:", json.dumps(prof))
    launches = {
        "slab_apply_lean": decided_launches["slab_apply_lean"],
        "slab_apply_decide": packed_launches["slab_apply_decide"],
        "decide": packed_launches["decide"],
    }
    # the way scan at this shape: the stream's table and one staged block,
    # in each form against the plain version, and captured in a CUDA graph
    probe = expand_ids(S, staged[1])
    scan = {"table": state.table, "fp_lo": probe.fp_lo, "fp_hi": probe.fp_hi, "launches": decided_launches["way_scan"]}
    way_scan_forms_parity(M, state.table, probe.fp_lo, probe.fp_hi, now, ways, "the decided stream's table", scan_errs)
    way_scan_graph_check(M, scan, now, ways)
    return out, launches, scan


def select_inputs(rng, n: int) -> np.ndarray:
    """Full-range int32 with every edge value (and its neighbours) first."""
    x = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
    edges = np.array([e + d for e in SELECT_EDGES for d in (-1, 0, 1)], np.int64)
    edges = ((edges + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    x[: edges.size] = edges
    return x


def tool_input(n: int) -> np.ndarray:
    """The tool's first input: RandomState(0).randint(0, 2^31) as int32."""
    return np.random.RandomState(0).randint(0, 1 << 31, size=n).astype(np.int32)


def phase_compare_paths(M, dev) -> tuple[dict, dict]:
    """sel and chain against their plain versions, bit-exact: at b = 2^20
    (full range with the edges, and the tool's own input), at a length that
    is not a multiple of 128, and on a buffer off 16-byte alignment (the
    kernels' scalar path). Then the port's tool in process at its default
    b = 2^20 (its JSON line prints here): the main path of both kernels.
    Returns (max abs errors, the tool run's launch counts)."""
    K, SEL, CMP = M.K, M.SEL, M.CMP
    rng = np.random.default_rng(4)
    full = torch.from_numpy(select_inputs(rng, SELECT_BATCH + 1)).to(dev)
    cases = {
        "b=2^20 full range": full[:SELECT_BATCH],
        "b=2^20 tool input": torch.from_numpy(tool_input(SELECT_BATCH)).to(dev),
        "b=2^20-37": full[: SELECT_BATCH - 37].clone(),
        "unaligned b=2^20": full[1:],
    }
    err = {"sel": 0, "chain": 0}
    for label, x in cases.items():
        for name, kernel, plain in (("sel", SEL.sel, SEL.sel_plain), ("chain", SEL.chain, SEL.chain_plain)):
            got = kernel(x)
            want = plain(x)
            torch.cuda.synchronize()
            e = max_abs_err([got], [want])
            check(e == 0, f"{name} differs from its plain version on {label}")
            err[name] = max(err[name], e)
    edges = torch.tensor(SELECT_EDGES, dtype=torch.int32, device=dev)
    got = SEL.sel(edges).cpu().tolist()
    check(got[0] == INT_MIN and got[2] == INT_MAX, f"sel wraps wrongly at the int32 edges: {got}")
    check(SEL.chain(edges).cpu().tolist() == SEL.chain_plain(edges.cpu()).tolist(), "chain differs at the int32 edges")
    K.reset_launch_counts()
    results = CMP.main(["--batch", str(SELECT_BATCH)])
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"sel": launches["sel"], "chain": launches["chain"]}
    check(launches["sel"] > 0 and launches["chain"] > 0 and launches == want, f"the tool launched {launches}")
    check(results["platform"] == "cuda" and results["batch"] == SELECT_BATCH, f"unexpected tool header {results}")
    log(f"compare-paths: bit-exact on {list(cases)} and the int32 edges; tool launches {launches}")
    return err, {"sel": launches["sel"], "chain": launches["chain"]}


def windowed_engines(M, dev) -> tuple[dict, dict]:
    """The three arms at the reference's default deployment: 2^22 slots,
    W=128, the production sketch, max_batch 65536, buckets 128 ... 65536,
    precompiled; the windowed two at TPU_BATCH_WINDOW=200us."""
    common = {
        "n_slots": N_SLOTS, "ways": 128, "buckets": BUCKETS, "device": dev,
        "hotkey_lanes": HOTKEY_LANES, "hotkey_k": HOTKEY_K, "max_batch": BUCKETS[-1], "precompile": True,
    }
    arms = {
        "dispatch_loop": {"batch_window_seconds": WINDOW_S, "dispatch_loop": True},
        "leader_collects": {"batch_window_seconds": WINDOW_S, "dispatch_loop": False},
        "direct": {"batch_window_seconds": 0.0},
    }
    clocks = {name: M.utils.FakeTimeSource(NOW0) for name in arms}
    engines = {name: M.cuda_mod.SlabDeviceEngine(clocks[name], **common, **kw) for name, kw in arms.items()}
    for name, eng in engines.items():
        check(len(eng.precompiled) == 3 * len(BUCKETS), f"{name} engine did not warm every shape")
        check((eng.dispatch_loop is not None) == (name == "dispatch_loop"), f"{name} engine has the wrong arm")
    return engines, clocks


def arm_batches(name: str, engine) -> tuple[int, int]:
    """(batches launched, of which launched while another was in flight)
    as the arm itself counts them."""
    counter = engine.dispatch_loop if name == "dispatch_loop" else engine.batcher
    return counter.launches, counter.overlapped_launches


def concurrent_run(engine, blocks: list) -> tuple[float, np.ndarray]:
    """CLIENT_THREADS threads, each submitting its share of the
    single-descriptor blocks one at a time; returns (wall seconds,
    per-request latencies in ms)."""
    lat = [[] for _ in range(CLIENT_THREADS)]
    start = threading.Barrier(CLIENT_THREADS + 1)
    errors = []

    def client(k):
        mine = blocks[k::CLIENT_THREADS]
        out = lat[k]
        start.wait()
        try:
            for block in mine:
                t0 = time.perf_counter()
                engine.submit_rows(block)
                out.append((time.perf_counter() - t0) * 1e3)
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(CLIENT_THREADS)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600.0)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(not errors, f"a client failed: {errors[:1]}")
    return wall, np.concatenate([np.asarray(x) for x in lat])


def check_counts(engine, block: np.ndarray, label: str) -> dict:
    """Every key's count in the table equals its total hits in `block`
    (1 per request), short only by what the lossy events explain: each
    drop or live eviction shortens at most one key. No key may exceed its
    hits."""
    table = engine.export_tables()[0]
    live = table[table[:, 4].astype(np.int64) > NOW0]
    check(live.shape[0] > 0, f"{label}: no live row after the run")
    fp = (live[:, 1].astype(np.uint64) << np.uint64(32)) | live[:, 0].astype(np.uint64)
    order = np.argsort(fp)
    fp, stored = fp[order], live[order, 2].astype(np.int64)
    req = (block[1].astype(np.uint64) << np.uint64(32)) | block[0].astype(np.uint64)
    keys, hits = np.unique(req, return_counts=True)
    pos = np.minimum(np.searchsorted(fp, keys), fp.size - 1)
    counts = np.where(fp[pos] == keys, stored[pos], 0)
    snap = engine.health_snapshot()
    short = int((counts < hits).sum())
    check(not (counts > hits).any(), f"{label}: a key counted more than its hits")
    check(short <= snap["drops"] + snap["evictions_live"], f"{label}: {short} keys short, {snap['drops']} drops, {snap['evictions_live']} live evictions")
    check(snap["decisions"] == block.shape[1], f"{label}: decisions {snap['decisions']} != {block.shape[1]} items")
    return {"keys": int(keys.size), "short_keys": short, "drops": snap["drops"], "evictions_live": snap["evictions_live"], "decisions": snap["decisions"]}


def phase_windowed(M, dev) -> dict:
    """The windowed serving path (module docstring, phase 7)."""
    K = M.K
    t_phase = time.perf_counter()
    rng = np.random.default_rng(6)
    sizes = rng.integers(1, 65, SERIAL_SUBMITS)
    serial = key_block(zipf_keys(rng, int(sizes.sum())))
    stream = key_block(zipf_keys(rng, WINDOWED_REQUESTS))
    engines, clocks = windowed_engines(M, dev)
    off = 0
    for i, n in enumerate(sizes):
        if i % 50 == 49:
            for clock in clocks.values():
                clock.advance(61)
        block = np.ascontiguousarray(serial[:, off : off + n])
        off += n
        # a copy: the loop's result is a view of the thread's ticket buffer
        outs = {name: eng.submit_rows(block).copy() for name, eng in engines.items()}
        want = outs["direct"].tobytes()
        check(all(o.tobytes() == want for o in outs.values()), f"windowed arms answer differently at serial submit {i}")
    tables = {name: eng.export_tables()[0] for name, eng in engines.items()}
    check(all(np.array_equal(t, tables["direct"]) for t in tables.values()), "windowed arms leave different tables")
    sketches = [eng.export_sketch() for eng in engines.values()]
    check(all(np.array_equal(s, sketches[0]) for s in sketches), "windowed arms leave different sketch planes")
    health = [eng.health_snapshot() for eng in engines.values()]
    check(all(h == health[0] for h in health), f"windowed arms report different health: {health}")
    t_serial = time.perf_counter() - t_phase
    for eng in engines.values():
        eng.close()
    del engines, tables
    torch.cuda.empty_cache()

    out = {"serial_submits": int(SERIAL_SUBMITS), "serial_items": int(sizes.sum()), "serial_s": t_serial, "window_s": WINDOW_S, "threads": CLIENT_THREADS}
    engines, _clocks = windowed_engines(M, dev)
    for name, eng in engines.items():
        n_req = DIRECT_REQUESTS if name == "direct" else WINDOWED_REQUESTS
        blocks = [np.ascontiguousarray(stream[:, i : i + 1]) for i in range(n_req)]
        batches0, overlapped0 = arm_batches(name, eng)
        K.reset_launch_counts()
        wall, lat = concurrent_run(eng, blocks)
        eng.flush()
        launches = dict(K.LAUNCHES)
        batches, overlapped = arm_batches(name, eng)
        batches -= batches0
        overlapped -= overlapped0
        want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": batches, "slab_apply": batches, "sketch_update": batches}
        check(launches == want, f"{name}: launches {launches} against {batches} batches")
        counts = check_counts(eng, stream[:, :n_req], name)
        mean_batch = n_req / batches
        probe = np.ascontiguousarray(stream[:, : max(1, round(mean_batch))])
        prof = profile_call(lambda eng=eng, probe=probe: eng.submit_rows(probe))
        out[name] = {
            "requests": n_req,
            "requests_per_s": n_req / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batches": batches,
            "mean_batch": mean_batch,
            "overlapped_launches": overlapped,
            "device_busy_share_profiled_batch": prof["device_busy_share"],
            "profiled_batch_items": int(probe.shape[1]),
            "profiled_batch_wall_ms": prof["wall_ms"],
            "profiled_batch_device_ms": prof["device_ms"],
            "wall_s": wall,
            "launches": launches,
            **counts,
        }
        log(
            f"windowed {name}: {n_req} requests from {CLIENT_THREADS} threads, {out[name]['requests_per_s']:.0f} req/s,"
            f" p50 {out[name]['p50_ms']:.3f} ms p99 {out[name]['p99_ms']:.3f} ms, {batches} batches (mean {mean_batch:.2f},"
            f" {overlapped} launched while another was in flight), busy {prof['device_busy_share']:.3f}"
        )
        eng.close()
    del engines
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("windowed:", json.dumps(out))
    return out


# --- phase 8: the sibling algorithms ------------------------------------------

ALGO_KEYS = 1 << 20  # the served mix's Zipf universe
ALGO_BATCHES = 16
ALGO_ORACLE_BATCHES = 4
ALGO_STEP_S = 7  # `now` advances 7 s a batch: windows roll, TATs drain
ALGO_BURST = 1.5  # GCRA_BURST_RATIO of the mix
ALGO_RELEASE_SHARE = 0.1  # of the concurrency items
ALGO_DECIDED_STEPS = 1
ALGO_TIMED_SUBMITS = 10
ALGO_NAMES = ("fixed_window", "sliding_window", "gcra", "concurrency")
ALGO_RULES = {
    "domain": "algo",
    "descriptors": [
        {"key": "fixed", "rate_limit": {"unit": "minute", "requests_per_unit": 5}},
        {"key": "slide", "rate_limit": {"unit": "minute", "requests_per_unit": 6, "algorithm": "sliding_window"}},
        {"key": "bucket", "rate_limit": {"unit": "minute", "requests_per_unit": 4, "algorithm": "gcra"}},
        {"key": "conns", "rate_limit": {"requests_per_unit": 3, "algorithm": "concurrency"}},
    ],
}
# bench.py bench_boundary_burst's tier: 64 keys, limit 100, 60 s windows, a
# 4096-slot table; the churn run's cap 32 and idle TTL 40 s
BURST_KEYS, BURST_LIMIT, BURST_DIV, BURST_SLOTS = 64, 100, 60, 1 << 12
CHURN_CAP, CHURN_TTL, CHURN_WAVES = 32, 40, 60


def algo_fingerprints(keys: np.ndarray, n_sets: int) -> tuple[np.ndarray, np.ndarray]:
    """fingerprints() with the set index taken from the key id's low bits
    and the id's next 5 bits in fp_hi's top bits, the bits the step's sort
    key breaks ties with: distinct keys of one set never share them, the
    one case SetSlabOracle does not model (ops/slab.py _sort_key). Needs
    keys < 32 x n_sets."""
    lo, hi = fingerprints(keys)
    set_bits = n_sets.bit_length() - 1
    k = keys.astype(np.uint64)
    check(int(k.max()) < (32 << set_bits), "too many keys for the oracle's fingerprints")
    lo = (lo & ~np.uint32(n_sets - 1)) | (k & np.uint64(n_sets - 1)).astype(np.uint32)
    hi = ((k >> np.uint64(set_bits)).astype(np.uint32) << np.uint32(27)) | (hi & np.uint32((1 << 27) - 1))
    return lo, hi


def algo_block(S, rng, keys: np.ndarray, n_sets: int) -> np.ndarray:
    """uint32[6, n] row block of the four-algorithm mix: a key's algorithm
    is its id mod 4 (fixed window, sliding window, GCRA, concurrency), its
    limit 5, 100 or 1000 and its window 1 s, 60 s or 1 h by id (a
    concurrency cap's window is its 60 s idle TTL); one concurrency item in
    ten is a release row; 1 hit, a jitter of id mod 7."""
    n = keys.size
    block = np.empty((6, n), np.uint32)
    block[0], block[1] = algo_fingerprints(keys, n_sets)
    block[2] = 1
    algo = (keys % 4).astype(np.uint32)
    block[3] = np.array([5, 100, 1000], np.uint32)[(keys // 4) % 3]
    div = np.array([1, 60, 3600], np.uint32)[(keys // 12) % 3]
    div = np.where(algo == S.ALGO_CONCURRENCY, np.uint32(60), div)
    release = (algo == S.ALGO_CONCURRENCY) & (rng.random(n) < ALGO_RELEASE_SHARE)
    algo = np.where(release, np.uint32(S.ALGO_CONC_RELEASE), algo)
    block[4] = div | (algo << np.uint32(S.ALGO_SHIFT))
    block[5] = (keys % 7).astype(np.uint32)
    return block


def algo_operand(block: np.ndarray, now: int, burst: float = ALGO_BURST) -> np.ndarray:
    """The launch operand uint32[7, n] of a row block: `now`, near_ratio 0.8
    and the GCRA burst ratio in the scalar row, as the engine packs it."""
    op = np.zeros((7, block.shape[1]), np.uint32)
    op[:6] = block
    op[6, 0] = now
    op[6, 1] = np.float32(0.8).view(np.uint32)
    op[6, 2] = np.float32(burst).view(np.uint32)
    return op


def unsorted_rows(out: torch.Tensor, S) -> dict:
    """before, after and code of a packed step's uint32[9, b] block in
    arrival order, on the host."""
    host = out.view(torch.int32).cpu().numpy().view(np.uint32)
    order = host[S.OUT_ORDER].astype(np.int64)
    res = {}
    for name, row in (("before", S.OUT_BEFORE), ("after", S.OUT_AFTER), ("code", S.OUT_CODE)):
        arr = np.empty(host.shape[1], np.uint32)
        arr[order] = host[row]
        res[name] = arr
    return res


def grace_rows(rng, table: np.ndarray, now: int, ways: int, sets) -> None:
    """In each of `sets`: a sliding-window row in its grace window (window +
    div <= now < window + 2 div, count 9) beside a fixed row of lower count
    (3) in its current window, the set's other ways live, in window and
    fuller (50): the fixed-window scan evicts the sliding row, the
    multi-algorithm one the fixed row."""
    div = 60
    win = (now // div) * div
    for s in sets:
        a, b = (s * ways + w for w in rng.choice(ways, 2, replace=False))
        for w in range(ways):
            table[s * ways + w] = (*rng.integers(0, 1 << 32, 2, dtype=np.uint64), 50, win, now + 50, div, 0, 0)
        table[a, 2:7] = (9, win - div, now + 50, div | (1 << 28), 4)
        table[b, 2:6] = (3, win, now + 50, div)


def algo_scan_inputs(rng, b: int, n_slots: int, ways: int, now: int, dev, crowd_share: float = 0.25):
    """scan_inputs' batch over a table of every algorithm's rows: random
    algorithm ids (0-7, so unknown ids too) on the adversarial rows, a
    quarter of them sliding rows in their grace window, and grace_rows in
    the crowded set 7 and 64 more sets."""
    lo, hi = fingerprints(rng.integers(0, 1 << 40, b))
    n_sets = n_slots // ways
    crowd = rng.random(b) < crowd_share
    lo[crowd] = (lo[crowd] & ~np.uint32(n_sets - 1)) | np.uint32(7 % n_sets)
    lo[-b // 16 :] = 0
    hi[-b // 16 :] = 0
    t = adversarial_table(rng, n_slots, now, lo, hi, ways)
    t[:, 5] |= rng.integers(0, 8, n_slots).astype(np.uint32) << np.uint32(28)
    div = (t[:, 5] & np.uint32((1 << 28) - 1)).astype(np.int64)
    g = rng.random(n_slots) < 0.25
    t[g, 3] = (now // div[g]) * div[g] - div[g]
    t[g, 4] = now + 1 + rng.integers(0, 100, int(g.sum()))
    t[g, 5] = div[g] | (1 << 28)
    grace_rows(rng, t, now, ways, sorted({7 % n_sets, *rng.choice(n_sets, min(64, n_sets), replace=False).tolist()}))
    return i32(t, dev), i32(lo, dev), i32(hi, dev)


def algo_scan_parity(M, dev, err: dict) -> dict:
    """(a) The multi-algorithm instantiation of both way-scan forms and the
    shipped routing against way_scan_plain(multi_algo=True) at W in {4,
    128}: the buckets and a 2^20 batch with 60% of it in one set, over
    tables of every algorithm's rows with sliding rows in their grace
    window beside fixed rows of lower count. Each batch must also pick
    differently from the fixed-window scan somewhere (the grace decides)."""
    K = M.K
    rng = np.random.default_rng(8)
    differs = {}
    for ways in (4, 128):
        for b in (*BUCKETS, DECIDED_BATCH):
            share = 0.6 if b == DECIDED_BATCH else 0.25
            table, lo, hi = algo_scan_inputs(rng, b, N_SLOTS, ways, NOW0, dev, crowd_share=share)
            label = f"{'skewed ' if b == DECIDED_BATCH else ''}b={b} W={ways} (every algorithm)"
            want = way_scan_forms_parity(M, table, lo, hi, NOW0, ways, label, err, multi_algo=True)
            fixed = K.way_scan_plain(table, lo, hi, NOW0, ways)
            n_diff = int((want[0] != fixed[0]).sum())
            check(n_diff > 0, f"the sliding grace changed no pick at {label}")
            differs[f"b={b} W={ways}"] = n_diff
            del table, lo, hi, want, fixed
    return differs


def served_mix(S, rng, n_batches: int, n_slots: int, ways: int = 128) -> list:
    return [algo_block(S, rng, zipf_keys(rng, BUCKETS[-1], ALGO_KEYS), n_slots // ways) for _ in range(n_batches)]


def algo_served(M, dev) -> dict:
    """(b) The served four-algorithm mix at the reference's default
    deployment (2^22 slots, W = 128, the production sketch, direct mode):
    16 batches of 65536 Zipf(1.1) items through SlabDeviceEngine.submit_rows
    on the card, `now` 7 s later each batch, against the same engine on the
    CPU: every after, the health, the table, the sketch planes and the
    drained hotkeys document. The card run is the main path of the
    multi-algorithm way scan (per item at this shape) and of the fused
    sketch update: its launches are counted. The first 4 batches again
    through slab_step_packed(multi_algo=True) on a second card table:
    before, after and code of every item and the health against
    SetSlabOracle."""
    K, S, O, cuda_mod, utils = M.K, M.S, M.O, M.cuda_mod, M.utils
    rng = np.random.default_rng(5)
    batches = served_mix(S, rng, ALGO_BATCHES, N_SLOTS)
    hot = {"hotkey_lanes": HOTKEY_LANES, "hotkey_k": HOTKEY_K, "gcra_burst_ratio": ALGO_BURST, "ways": 128, "n_slots": N_SLOTS}
    clocks = {"cuda": utils.FakeTimeSource(NOW0), "cpu": utils.FakeTimeSource(NOW0)}
    engines = {name: cuda_mod.SlabDeviceEngine(clock, device=name, **hot) for name, clock in clocks.items()}
    check(not engines["cuda"].algos_seen, "a fresh engine's guard is already flipped")
    afters = {}
    for name in ("cuda", "cpu"):
        eng, clock = engines[name], clocks[name]
        if name == "cuda":
            K.reset_launch_counts()
        t0 = time.perf_counter()
        afters[name] = []
        for block in batches:
            clock.advance(ALGO_STEP_S)
            afters[name].append(eng.submit_rows(block).copy())
        if name == "cuda":
            torch.cuda.synchronize()
            launches, multi_forms, fixed_forms = dict(K.LAUNCHES), dict(K.WAY_SCAN_MULTI_FORMS), dict(K.WAY_SCAN_FORMS)
        elapsed = time.perf_counter() - t0
        log(f"algorithms served mix on {name}: {len(batches)} x {BUCKETS[-1]} items in {elapsed:.1f} s")
    n = len(batches)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": n, "sketch_update": n}
    check(launches == want, f"the served mix launched {launches}, expected {want}")
    form = K.way_scan_form(BUCKETS[-1], N_SLOTS // 128, 128)  # per item at 65536 over 2^22 slots
    check(multi_forms == dict.fromkeys(multi_forms, 0) | {form: n} and not any(fixed_forms.values()),
          f"the served mix's way scans ran as {multi_forms} (multi) and {fixed_forms} (fixed)")
    check(engines["cuda"].algos_seen, "the served mix did not flip the guard")
    for i in range(n):
        check(np.array_equal(afters["cuda"][i], afters["cpu"][i]), f"served mix afters differ from the CPU's at batch {i}")
    tables = {name: eng.export_tables()[0] for name, eng in engines.items()}
    check(np.array_equal(tables["cuda"], tables["cpu"]), "served mix tables differ from the CPU's")
    check(np.array_equal(engines["cuda"].export_sketch(), engines["cpu"].export_sketch()), "served mix sketch planes differ")
    health = {name: eng.health_snapshot() for name, eng in engines.items()}
    check(health["cuda"] == health["cpu"], f"served mix health differs: {health}")
    drained = {name: eng.drain_hotkeys() for name, eng in engines.items()}
    docs = {name: json.dumps(eng.hotkeys_snapshot(), indent=2) for name, eng in engines.items()}
    check(drained["cuda"] == drained["cpu"] and docs["cuda"] == docs["cpu"], "served mix hotkeys documents differ")
    algos = (tables["cuda"][:, 5] >> np.uint32(S.ALGO_SHIFT)) & np.uint32(7)
    stored = {ALGO_NAMES[a]: int((algos[tables["cuda"][:, 4] != 0] == a).sum()) for a in range(4)}
    check(all(stored.values()), f"the served mix stored no row of some algorithm: {stored}")
    check(bool(tables["cuda"][:, 6].any()) and bool(tables["cuda"][:, 7].any()), "columns 6-7 were never written")

    # the oracle: before/after/code of every item through the packed step
    twin = S.make_slab(N_SLOTS, dev)
    oracle = O.SetSlabOracle(N_SLOTS, 128, burst_ratio=ALGO_BURST)
    t0 = time.perf_counter()
    for i, block in enumerate(batches[:ALGO_ORACLE_BATCHES]):
        now = NOW0 + ALGO_STEP_S * (i + 1)
        out, health_dev = S.slab_step_packed(twin, algo_operand(block, now), ways=128, multi_algo=True)
        got = unsorted_rows(out, S)
        cap = np.uint32(0xFF if int(block[2].max()) + int(block[3].max()) < 255 else 0xFFFF)
        check(np.array_equal(np.minimum(got["after"], cap), afters["cuda"][i]), f"the packed step's afters differ from the engine's at batch {i}")
        items = list(zip(*(block[r].tolist() for r in range(6))))
        w_before, w_after, w_codes, w_delta = oracle.step_batch(items, now)
        check(got["before"].tolist() == w_before and got["after"].tolist() == w_after, f"served mix before/after differ from SetSlabOracle at batch {i}")
        check(got["code"].tolist() == w_codes, f"served mix codes differ from SetSlabOracle at batch {i}")
        check([int(v) for v in health_dev.tolist()] == w_delta, f"served mix health differs from SetSlabOracle at batch {i}")
    check(np.array_equal(S.slab_export_copy(twin).astype(np.uint64), oracle.table), "the packed twin's table differs from SetSlabOracle's")
    oracle_s = time.perf_counter() - t0
    codes_over = [int((a > batches[i][3]).sum()) for i, a in enumerate(afters["cuda"])]
    del twin, oracle
    torch.cuda.empty_cache()
    return {
        "engine": engines["cuda"],
        "batches": batches,
        "launches": launches,
        "multi_forms": multi_forms,
        "summary": {
            "n_slots": N_SLOTS, "ways": 128, "batches": n, "batch": BUCKETS[-1], "burst_ratio": ALGO_BURST,
            "stored_rows": stored, "over_limit_per_batch": codes_over, "health": health["cuda"],
            "oracle_batches": ALGO_ORACLE_BATCHES, "oracle_s": oracle_s,
            "hotkeys_top": drained["cuda"][:3],
        },
    }


def algo_http(M) -> dict:
    """(b) /json and POST /release through HttpServer on the card and on
    the CPU (the four rules of ALGO_RULES): statuses and bodies equal, the
    concurrency cap denying its fourth holder until one release frees a
    slot, the sliding window and GCRA denying past their limits."""
    K = M.K

    def req(key, path="/json"):
        body = json.dumps({"domain": "algo", "descriptors": [{"entries": [{"key": key}]}]}).encode()
        return (path, body) if path != "/json" else body

    bodies = [req("conns")] * 4 + [req("conns", "/release"), req("conns"), req("conns")]
    bodies += [req("slide")] * 7 + [req("bucket")] * 5 + [req("fixed")] * 6 + [req("slide"), req("bucket")]
    steps = [0] * (len(bodies) - 2) + [60, 15]
    K.reset_launch_counts()
    got, got_doc, _ = serve("cuda", bodies, rules=ALGO_RULES, clock_steps=steps)
    launches = dict(K.LAUNCHES)
    multi_forms = dict(K.WAY_SCAN_MULTI_FORMS)
    want, want_doc, _ = serve("cpu", bodies, rules=ALGO_RULES, clock_steps=steps)
    statuses = [s for s, _ in got]
    check(got == want, f"card and CPU answers to the algorithm rules differ:\n{got}\n{want}")
    check(got_doc == want_doc, "card and CPU /debug/hotkeys of the algorithm rules differ")
    check(statuses[:4] == [200, 200, 200, 429], f"the concurrency cap did not hold: {statuses[:4]}")
    check(got[4] == (200, b'{"released": 1}'), f"POST /release answered {got[4]}")
    check(statuses[5:7] == [200, 429], f"the release did not free exactly one slot: {statuses[5:7]}")
    check(statuses[7:14] == [200] * 6 + [429] and statuses[14:19] == [200] * 4 + [429], f"sliding/GCRA statuses {statuses[7:19]}")
    check(statuses[19:25] == [200] * 5 + [429], f"fixed-window statuses {statuses[19:25]}")
    check(statuses[25:] == [200, 200], f"the next window's sliding carry or the drained TAT denied: {statuses[25:]}")
    check(multi_forms["per_item"] > 0 and launches["sketch_update"] > 0, f"the algorithm rules' launches {launches} {multi_forms}")
    log(f"algorithms http: statuses {statuses}, launches {launches}, multi way scans {multi_forms}")
    return {"statuses": statuses, "launches": launches}


def boundary_burst(M, device) -> dict:
    """(c) bench.py bench_boundary_burst on the port: 64 keys, limit 100,
    60 s windows, a 4096-slot table (W = 128), each key offering `limit`
    one-hit requests in the last quarter of a window and `limit` more in
    the first quarter of the next, per algorithm; then the churn run (cap
    32, idle TTL 40 s, 60 acquire waves, 25% of sessions leaking) and the
    TTL reclaim. Every launch is slab_step_packed(multi_algo=True)."""
    S = M.S
    ways = 128

    def launch(state, rows_div, now, limit, ids):
        p = np.zeros((7, BURST_KEYS), np.uint32)
        p[S.ROW_FP_LO], p[S.ROW_FP_HI] = fmix32(ids), fmix32(ids ^ np.uint32(0x5A5A5A5A))
        p[S.ROW_HITS] = 1
        p[S.ROW_LIMIT] = limit
        p[S.ROW_DIVIDER] = rows_div
        p[S.ROW_SCALARS, 0] = np.uint32(now)
        p[S.ROW_SCALARS, 1] = np.float32(0.8).view(np.uint32)
        out, _h = S.slab_step_packed(state, p, ways=ways, multi_algo=True)
        return unsorted_rows(out, S)["code"]

    w0 = 1_000_000 * BURST_DIV // BURST_DIV * BURST_DIV
    edge = [(w0 + BURST_DIV - 8 + 2 * k, BURST_LIMIT // 4) for k in range(4)]
    edge += [(w0 + BURST_DIV + 2 + 2 * k, BURST_LIMIT // 4) for k in range(4)]
    result: dict = {"limit": BURST_LIMIT, "offered_per_key": 2 * BURST_LIMIT}
    for name, algo in (("fixed_window", 0), ("sliding_window", S.ALGO_SLIDING_WINDOW), ("gcra", S.ALGO_GCRA)):
        state = S.make_slab(BURST_SLOTS, device)
        ids = np.arange(BURST_KEYS, dtype=np.uint32) + np.uint32(0x1000 * (algo + 1))
        admitted = 0
        for now, per_key in edge:
            for _ in range(per_key):
                admitted += int((launch(state, BURST_DIV | (algo << S.ALGO_SHIFT), now, BURST_LIMIT, ids) == 1).sum())
        result[name] = {"admitted": admitted, "admitted_over_limit_ratio": admitted / BURST_KEYS / BURST_LIMIT}
    state = S.make_slab(BURST_SLOTS, device)
    rng = np.random.default_rng(12)
    ids = np.arange(BURST_KEYS, dtype=np.uint32) + np.uint32(0x9000)

    def conc(now, release):
        algo = np.where(release, S.ALGO_CONC_RELEASE, S.ALGO_CONCURRENCY).astype(np.uint32)
        return launch(state, np.uint32(CHURN_TTL) | (algo << np.uint32(S.ALGO_SHIFT)), now, CHURN_CAP, ids)

    now = w0 + 10 * BURST_DIV
    admitted = denied = 0
    max_count = 0
    leak = rng.random(size=(CHURN_WAVES, BURST_KEYS)) < 0.25
    for wave in range(CHURN_WAVES):
        codes = conc(now, np.zeros(BURST_KEYS, bool))
        admitted += int((codes == 1).sum())
        denied += int((codes == 2).sum())
        if not leak[wave].all():
            conc(now, ~leak[wave])
        table = S.slab_export_copy(state)
        conc_rows = ((table[:, 5] >> np.uint32(S.ALGO_SHIFT)) == S.ALGO_CONCURRENCY) & (table[:, 4] != 0)
        max_count = max(max_count, int(table[conc_rows, 2].max(initial=0)))
        now += 1
    now += CHURN_TTL + 5
    reclaimed = float(np.mean(conc(now, np.zeros(BURST_KEYS, bool)) == 1))
    result["connection_churn"] = {
        "cap": CHURN_CAP, "ttl_s": CHURN_TTL, "churn_admitted": admitted, "churn_denied": denied,
        "max_in_flight": max_count, "cap_bound_held": denied > 0 and max_count <= CHURN_CAP,
        "reclaimed_admit_rate": reclaimed,
    }
    return result


def algo_boundary_burst(M, dev) -> dict:
    """(c) boundary_burst on the card and on the CPU: equal counts; fixed
    window admits about 2x its limit across the edge, the sliding window at
    most 1 + the interpolation error (the edge's last arrival 8 s into the
    window: 8/60 of the limit, plus one for the floor), GCRA at most its
    burst (one window at ratio 1.0) plus what drains over the edge's 16 s;
    the churn cap holds and the TTL reclaims every leaked slot."""
    got = boundary_burst(M, dev)
    want = boundary_burst(M, "cpu")
    check(got == want, f"boundary burst counts differ between card and CPU:\n{got}\n{want}")
    r = {name: got[name]["admitted_over_limit_ratio"] for name in ("fixed_window", "sliding_window", "gcra")}
    check(1.9 <= r["fixed_window"] <= 2.0, f"fixed window admitted {r['fixed_window']} x its limit across the edge")
    check(r["sliding_window"] <= 1 + 8 / BURST_DIV + 1 / BURST_LIMIT, f"sliding window admitted {r['sliding_window']} x")
    check(r["gcra"] <= 1 + 16 / BURST_DIV + 1 / BURST_LIMIT, f"GCRA admitted {r['gcra']} x")
    churn = got["connection_churn"]
    check(churn["cap_bound_held"] and churn["reclaimed_admit_rate"] == 1.0, f"churn: {churn}")
    log("algorithms boundary burst:", json.dumps(got))
    return got


def staged_multi_step(M, state, batch, now: int):
    """The decided multi-algorithm step over a batch staged on the card:
    _slab_step_sorted(multi_algo=True) (the decide kernel after the body),
    the codes unsorted and the OVER bits packed on the card."""
    S, D = M.S, M.D
    _before, _after, d, order, health = S._slab_step_sorted(
        state, batch, now, 0.8, DECIDED_WAYS, lean=True, multi_algo=True, burst_ratio=ALGO_BURST
    )
    return D.packbits(S._unsort(d.code, order) == D.CODE_OVER_LIMIT), health


def algo_decided(M, dev) -> dict:
    """(d) slab_step_decided(multi_algo=True) at b = 2^20 over 2^23 slots
    (W = 128) on the four-algorithm mix, one step from an empty table: every
    code against SetSlabOracle, the launches (the set-major multi way scan
    and the decide kernel once a step, no apply). Then the step staged on
    the card, its device ms and activities against the fixed-window staged
    step of the decided phase in the same call."""
    K, S, O, D = M.K, M.S, M.O, M.D
    ways = DECIDED_WAYS
    rng = np.random.default_rng(6)
    n_sets = DECIDED_SLOTS // ways
    blocks = [algo_block(S, rng, zipf_keys(rng, DECIDED_BATCH, ALGO_KEYS), n_sets) for _ in range(ALGO_DECIDED_STEPS)]
    state = S.make_slab(DECIDED_SLOTS, dev)
    oracle = O.SetSlabOracle(DECIDED_SLOTS, ways, burst_ratio=ALGO_BURST)
    decide_args = []
    real_decide = S.decide_items

    def record(*args):
        decide_args.append(args)
        return real_decide(*args)

    K.reset_launch_counts()
    S.decide_items = record
    codes = []
    try:
        for i, block in enumerate(blocks):
            c, _h = S.slab_step_decided(state, algo_operand(block, NOW0 + ALGO_STEP_S * i), ways=ways, multi_algo=True)
            codes.append(c.cpu().numpy())
    finally:
        S.decide_items = real_decide
    launches, forms = dict(K.LAUNCHES), dict(K.WAY_SCAN_MULTI_FORMS)
    n = len(blocks)
    want = dict.fromkeys(K.LAUNCHES, 0) | {"way_scan": n, "decide": n}
    check(launches == want, f"the decided multi steps launched {launches}, expected {want}")
    form = K.way_scan_form(DECIDED_BATCH, n_sets, ways)  # set-major at 2^20
    check(forms == dict.fromkeys(forms, 0) | {form: n}, f"the decided multi way scans ran as {forms}")
    t0 = time.perf_counter()
    over = []
    for i, block in enumerate(blocks):
        items = list(zip(*(block[r].tolist() for r in range(6))))
        _b, _a, w_codes, _delta = oracle.step_batch(items, NOW0 + ALGO_STEP_S * i)
        check(codes[i].tolist() == w_codes, f"decided multi codes differ from SetSlabOracle at step {i}")
        over.append(int((codes[i] == D.CODE_OVER_LIMIT).sum()))
    oracle_s = time.perf_counter() - t0
    del oracle
    args = decide_args[-1]
    decide_err = max_abs_err(M.D.decide(*args), M.D.decide_plain(*args))
    check(decide_err == 0, "decide differs from its plain version on the decided multi step's operands")

    # staged: the next block's rows on the card before timing
    nxt = algo_block(S, rng, zipf_keys(rng, DECIDED_BATCH, ALGO_KEYS), n_sets)
    staged = S.SlabBatch(*torch.from_numpy(nxt.view(np.int32)).to(dev))
    now = NOW0 + ALGO_STEP_S * n
    multi_fn = lambda: staged_multi_step(M, state, staged, now)  # noqa: E731
    per_call, by_name = traced_calls(multi_fn, 5)
    fixed_state = S.make_slab(DECIDED_SLOTS, dev)
    ids = torch.from_numpy(zipf_ids(DECIDED_KEYS, DECIDED_BATCH, 1, seed=3)[0].view(np.int32)).to(dev)
    fixed_fn = lambda: staged_step(M, fixed_state, ids, NOW0)  # noqa: E731
    f_per_call, f_by_name = traced_calls(fixed_fn, 5)
    out = {
        "n_slots": DECIDED_SLOTS, "ways": ways, "batch": DECIDED_BATCH, "steps": n, "over_limit": over,
        "oracle_s": oracle_s,
        "staged_multi_device_ms": summed_ms(per_call, by_name),
        "staged_multi_activities": sum(per_call.values()),
        "staged_multi_call_ms": call_ms(multi_fn, iters=5),
        "staged_fixed_device_ms": summed_ms(f_per_call, f_by_name),
        "staged_fixed_activities": sum(f_per_call.values()),
        "staged_fixed_call_ms": call_ms(fixed_fn, iters=5),
        "staged_multi_top_device_ms": profile_call(multi_fn)["top_device_ms"][:8],
    }
    del fixed_state
    torch.cuda.empty_cache()
    probe = staged
    return {
        "summary": out, "launches": launches, "forms": forms, "state": state,
        "scan": (state.table, probe.fp_lo, probe.fp_hi, now, ways), "decide_args": decide_args[-1],
        "decide_err": decide_err,
    }


def algo_timing(M, served: dict) -> dict:
    """Timing, no claim: submit_rows medians and device activities of one
    65536-item batch, a fixed-only engine (the guard unflipped, fixed
    rows) against the served mix's flipped engine (the mix); the
    multi-algorithm body's device ms and activities over a real served
    step's sorted operands."""
    S, cuda_mod, utils = M.S, M.cuda_mod, M.utils
    rng = np.random.default_rng(9)
    flipped = served["engine"]
    fixed = cuda_mod.SlabDeviceEngine(utils.FakeTimeSource(NOW0), n_slots=N_SLOTS, device="cuda", hotkey_lanes=HOTKEY_LANES, hotkey_k=HOTKEY_K)
    fixed_blocks = [key_block(zipf_keys(rng, BUCKETS[-1])) for _ in range(ALGO_TIMED_SUBMITS)]
    mix_blocks = served_mix(S, rng, ALGO_TIMED_SUBMITS, N_SLOTS)
    ms = {"fixed": [], "flipped": []}
    for i in range(ALGO_TIMED_SUBMITS):
        for name, eng, block in (("fixed", fixed, fixed_blocks[i]), ("flipped", flipped, mix_blocks[i]))[:: 1 if i % 2 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.submit_rows(block)
            ms[name].append((time.perf_counter() - t0) * 1e3)
    check(not fixed.algos_seen and flipped.algos_seen, "the timed engines' guards are not as set up")
    acts = {}
    for name, eng, block in (("fixed", fixed, fixed_blocks[0]), ("flipped", flipped, mix_blocks[0])):
        per_call, by_name = traced_calls(lambda e=eng, b=block: e.submit_rows(b), 5)
        acts[name] = (sum(per_call.values()), summed_ms(per_call, by_name))
    body_args, real = [], S._multi_algo_body

    def record(*args):
        body_args.append(args)
        return real(*args)

    S._multi_algo_body = record
    try:
        flipped.submit_rows(mix_blocks[1])
    finally:
        S._multi_algo_body = real
    args = body_args[0]
    body_fn = lambda: S._multi_algo_body(*args)  # noqa: E731
    per_call, by_name = traced_calls(body_fn, 10)
    return {
        "submit_ms_median_fixed": float(np.median(ms["fixed"])),
        "submit_ms_median_flipped": float(np.median(ms["flipped"])),
        "device_activities_fixed": acts["fixed"][0], "device_ms_fixed": acts["fixed"][1],
        "device_activities_flipped": acts["flipped"][0], "device_ms_flipped": acts["flipped"][1],
        "body_device_ms": summed_ms(per_call, by_name),
        "body_activities": sum(per_call.values()),
        "body_call_ms": call_ms(body_fn, iters=10),
        "body_top_device_ms": profile_call(body_fn)["top_device_ms"][:8],
    }


def phase_algorithms(M, dev) -> dict:
    """Phase 8 (module docstring): the sibling algorithms. Returns the
    operands and launch counts of the kernels line's multi-algorithm rows
    and the errors of the multi way scan's parity."""
    t_phase = time.perf_counter()
    errs: dict = {}
    differs = algo_scan_parity(M, dev, errs)
    log(f"algorithms scan parity: both forms and the shipped routing bit-exact in the multi-algorithm instantiation; picks the grace changed: {json.dumps(differs)}")
    served = algo_served(M, dev)
    log("algorithms served mix:", json.dumps(served["summary"]))
    http = algo_http(M)
    burst = algo_boundary_burst(M, dev)
    decided = algo_decided(M, dev)
    log("algorithms decided:", json.dumps(decided["summary"]))
    timing = algo_timing(M, served)
    log("algorithms timing:", json.dumps(timing))
    eng = served["engine"]
    lo, hi = (i32(a, dev) for a in algo_fingerprints(zipf_keys(np.random.default_rng(10), BUCKETS[-1], ALGO_KEYS), N_SLOTS // 128))
    log(f"algorithms: phase {time.perf_counter() - t_phase:.1f} s")
    errs["decide_multi"] = decided["decide_err"]
    return {
        "errs": errs,
        "served_scan": (eng._state.table, lo, hi, NOW0 + ALGO_STEP_S * ALGO_BATCHES, 128),
        "served_launches": sum(served["multi_forms"].values()),
        "decided_scan": decided["scan"],
        "decided_launches": sum(decided["forms"].values()),
        "decide_args": decided["decide_args"],
        "decide_launches": decided["launches"]["decide"],
        "http": http, "burst": burst, "keep": (eng, decided["state"]),
    }


def served_sketch_args(M, engine, rng) -> tuple:
    """The fused sketch update's operands in one real served step: one
    65536-item Zipf submit through the engine, its call recorded (the
    sorted fingerprints, the apply's segment weights, the candidate mask)."""
    SKT = M.SKT
    fused, seen = SKT.sketch_update_fused, []

    def record(*args):
        seen.append(args)
        return fused(*args)

    SKT.sketch_update_fused = record
    try:
        engine.submit_rows(key_block(zipf_keys(rng, BUCKETS[-1])))
    finally:
        SKT.sketch_update_fused = fused
    check(len(seen) == 1, f"one submit ran {len(seen)} sketch updates")
    return seen[0]


def kernel_report(M, engine, decided_scan: dict, dev, launches: dict, errs: dict, algo: dict) -> tuple[list, list]:
    """Times at each path's largest shape: the served path's b = 65536, W =
    128, over the engine phase's populated 2^22-slot table and 128-lane
    sketch (the sketch update over a real step's sorted candidates); the
    way scan also at the decided phase's b = 2^20 over its 2^23-slot table;
    the decision kernels at the decided phase's b = 2^20; sel and chain at
    the tool's b = 2^20 on its first input. ms, plain_ms and library_ms are
    median device times (device_ms); call_ms and plain_call_ms are
    CUDA-event medians around one call (call_ms). No single PyTorch call
    computes the way scan, the sketch's kernels, the decision, sel or chain
    (torch.where(x > NOW, x, -x) is three launches), so they have no
    library time; the applies' yardstick is the torch.cumsum of their
    hits, the first of their two scans, not the same function. Returns
    (the kernels line's rows, one per kernel of a path; the standalone
    sketch scan's row: off every path since the fused update took its
    place, it is timed at the served shape). `algo` (phase_algorithms)
    adds the multi-algorithm rows: the way scan's multi instantiation on
    the served mix's table (per item) and on the decided multi step's
    (set-major), and the decide kernel on that step's before/after; each
    way scan row is also timed in the fixed-window instantiation on the
    same operands, printed apart."""
    K, SKK, D = M.K, M.SKK, M.D
    rng = np.random.default_rng(3)
    b, ways = BUCKETS[-1], 128
    table = engine._state.table
    lo, hi = (i32(a, dev) for a in fingerprints(zipf_keys(rng, b)))
    now = NOW0 + 200
    planes = engine._sketch
    ops = apply_inputs(rng, b, now, dev)
    sk = served_sketch_args(M, engine, rng)
    big_table, big_lo, big_hi = decided_scan["table"], decided_scan["fp_lo"], decided_scan["fp_hi"]
    big = big_lo.shape[0]
    # label -> (kernel call, plain call, plain iterations, library call)
    calls = {
        "way_scan": (
            lambda: K.way_scan(table, lo, hi, now, ways), lambda: K.way_scan_plain(table, lo, hi, now, ways), 5, None,
        ),
        "way_scan_decided": (
            lambda: K.way_scan(big_table, big_lo, big_hi, NOW0, DECIDED_WAYS),
            lambda: K.way_scan_plain(big_table, big_lo, big_hi, NOW0, DECIDED_WAYS), 3, None,
        ),
        "slab_apply": (
            lambda: K.slab_apply(*ops, now), lambda: K.slab_apply_plain(*ops, now), 20,
            lambda: torch.cumsum(ops[2], dim=0),
        ),
        "sketch_update": (lambda: SKK.sketch_update_fused(*sk), lambda: SKK.sketch_update_plain(*sk), 20, None),
    }
    big_ops, limit, dec_ops = decide_inputs(M, rng, big, now, dev)
    for name, lean in (("slab_apply_decide", False), ("slab_apply_lean", True)):
        kw = {"s_limit": limit, "near_ratio": 0.8, "decide": True, "lean": lean}
        calls[name] = (
            lambda kw=kw: K.slab_apply(*big_ops, now, **kw), lambda kw=kw: K.slab_apply_plain(*big_ops, now, **kw), 20,
            lambda: torch.cumsum(big_ops[2], dim=0),
        )
    calls["decide"] = (lambda: D.decide(*dec_ops, now, 0.8), lambda: D.decide_plain(*dec_ops, now, 0.8), 20, None)
    m_served, m_decided, m_dec = algo["served_scan"], algo["decided_scan"], algo["decide_args"]
    calls["way_scan_multi"] = (
        lambda: K.way_scan(*m_served, multi_algo=True), lambda: K.way_scan_plain(*m_served, multi_algo=True), 5, None,
    )
    calls["way_scan_multi_decided"] = (
        lambda: K.way_scan(*m_decided, multi_algo=True), lambda: K.way_scan_plain(*m_decided, multi_algo=True), 3, None,
    )
    calls["decide_multi"] = (lambda: D.decide(*m_dec), lambda: D.decide_plain(*m_dec), 20, None)
    # the compare/select kernels on the tool's own first input
    x_sel = torch.from_numpy(tool_input(SELECT_BATCH)).to(dev)
    calls["sel"] = (lambda: M.SEL.sel(x_sel), lambda: M.SEL.sel_plain(x_sel), 20, None)
    calls["chain"] = (lambda: M.SEL.chain(x_sel), lambda: M.SEL.chain_plain(x_sel), 20, None)
    calls["sketch_scan"] = (
        lambda: SKK.sketch_scan(planes, lo, hi, ways), lambda: SKK.sketch_scan_plain(planes, lo, hi, ways), 20, None,
    )
    lanes = sk[0].shape[1]
    shape = {
        "way_scan": f"b={b}, W={ways}, {table.shape[0]}-slot table",
        "way_scan_decided": f"b={big}, W={DECIDED_WAYS}, {big_table.shape[0]}-slot table",
        "slab_apply": f"b={b}",
        "sketch_update": f"b={sk[1].shape[0]}, W={sk[5]}, {lanes} lanes, {int(sk[4].sum())} candidates",
        "slab_apply_decide": f"b={big}",
        "slab_apply_lean": f"b={big}",
        "decide": f"b={big}",
        "sel": f"b={SELECT_BATCH}",
        "chain": f"b={SELECT_BATCH}",
        "sketch_scan": f"b={b}, W={ways}, {planes.shape[1]} lanes",
        "way_scan_multi": f"b={m_served[1].shape[0]}, W={m_served[4]}, {m_served[0].shape[0]}-slot table, four-algorithm mix",
        "way_scan_multi_decided": f"b={m_decided[1].shape[0]}, W={m_decided[4]}, {m_decided[0].shape[0]}-slot table, four-algorithm mix",
        "decide_multi": f"b={m_dec[0].shape[0]}, the decided multi-algorithm step",
    }

    def sets_read(tbl, fp_lo, w):
        return int(torch.unique(fp_lo & (tbl.shape[0] // w - 1)).numel())

    # way scan: each distinct set is read once (Zipf traffic repeats
    # sets), plus the per-item queries and outputs; sketch update: fp_lo,
    # fp_hi, weight and the cand byte per item, the planes read once and
    # written once; sketch scan: the 8-byte query in and 13 bytes out per
    # item, the planes read once; the applies: 5 (decided 6) int32 planes,
    # the seg_start byte and 5 stored-row words in, 4 (decided 10, lean 5)
    # planes out; decide: 5 planes in, 6 out
    nbytes = {
        "way_scan": sets_read(table, lo, ways) * ways * 32 + b * (8 + 4 + 1 + 32),
        "way_scan_decided": sets_read(big_table, big_lo, DECIDED_WAYS) * DECIDED_WAYS * 32 + big * (8 + 4 + 1 + 32),
        "slab_apply": b * (5 * 4 + 1 + 5 * 4 + 4 * 4),
        "sketch_update": sk[1].shape[0] * (4 + 4 + 4 + 1) + 2 * sk[0].numel() * 4,
        "slab_apply_decide": big * (6 * 4 + 1 + 5 * 4 + 10 * 4),
        "slab_apply_lean": big * (6 * 4 + 1 + 5 * 4 + 5 * 4),
        "decide": big * (5 * 4 + 6 * 4),
        "sel": SELECT_BATCH * (4 + 4),
        "chain": SELECT_BATCH * (4 + 4),
        "sketch_scan": b * (8 + 13) + planes.numel() * 4,
    }
    for label, (tbl, q_lo, _hi, _now, w) in (("way_scan_multi", m_served), ("way_scan_multi_decided", m_decided)):
        nbytes[label] = sets_read(tbl, q_lo, w) * w * 32 + q_lo.shape[0] * (8 + 4 + 1 + 32)
    nbytes["decide_multi"] = m_dec[0].shape[0] * (5 * 4 + 6 * 4)
    kernel_launches = launches | {
        "way_scan_decided": decided_scan["launches"],
        "way_scan_multi": algo["served_launches"],
        "way_scan_multi_decided": algo["decided_launches"],
        "decide_multi": algo["decide_launches"],
    }
    # the way scan rows run the shipped routing; the form it takes there
    scan_forms = {
        "way_scan": K.way_scan_form(b, table.shape[0] // ways, ways),
        "way_scan_decided": K.way_scan_form(big, big_table.shape[0] // DECIDED_WAYS, DECIDED_WAYS),
    }
    for label, (tbl, q_lo, _hi, _now, w) in (("way_scan_multi", m_served), ("way_scan_multi_decided", m_decided)):
        scan_forms[label] = K.way_scan_form(q_lo.shape[0], tbl.shape[0] // w, w)
    names = {"way_scan_decided": "way_scan", "way_scan_multi_decided": "way_scan_multi", "decide_multi": "decide"}
    rows = []
    for label, (kernel, plain, plain_iters, library) in calls.items():
        name = names.get(label, label)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "shape": shape[label],
            "launches": kernel_launches[label],
            "max_abs_err": errs.get(label, errs[name]),
            "ms": device_ms(kernel),
            "plain_ms": device_ms(plain, iters=plain_iters),
            "bound_ms": nbytes[label] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None if library is None else device_ms(library),
            "call_ms": call_ms(kernel),
            "plain_call_ms": call_ms(plain, iters=plain_iters),
            **({"form": scan_forms[label]} if label in scan_forms else {}),
            **({"path": "multi_algo"} if label in ("way_scan_multi", "way_scan_multi_decided", "decide_multi") else {}),
        })
    forms = way_scan_forms_report(M, {
        f"b={b}": (table, lo, hi, now, ways),
        "b=2^20": (big_table, big_lo, big_hi, NOW0, DECIDED_WAYS),
    })
    log("way scan, each form beside the shipped routing on the same operands:", json.dumps(forms))
    both = {}
    for label, args in (("served mix b=65536", m_served), ("decided mix b=2^20", m_decided)):
        both[label] = {
            inst: {"ms": device_ms(lambda multi=multi: K.way_scan(*args, multi_algo=multi)),
                   "call_ms": call_ms(lambda multi=multi: K.way_scan(*args, multi_algo=multi))}
            for inst, multi in (("fixed", False), ("multi", True))
        }
    log("way scan, fixed-window beside multi-algorithm instantiation on the same operands:", json.dumps(both))
    log("sketch update, the parent's two-kernel form beside the fused kernel:", json.dumps(two_kernel_sketch(M, sk)))
    standalone = [row for row in rows if row["name"] == "sketch_scan"]
    return [row for row in rows if row["name"] != "sketch_scan"], standalone


def way_scan_forms_report(M, shapes: dict) -> dict:
    """Each form of the way scan on the operands of the kernels line's way
    scan rows: the form the shipped routing takes there, and per form the
    device ms (device_ms's counting), the CUDA-event call ms, the device
    activities of one call and each activity's runs a call and median
    microseconds."""
    K = M.K
    out = {}
    for label, (table, lo, hi, now, ways) in shapes.items():
        row = {"shipped": K.way_scan_form(lo.shape[0], table.shape[0] // ways, ways)}
        for form in K.WAY_SCAN_FORM_NAMES:
            fn = lambda form=form: K.way_scan(table, lo, hi, now, ways, form=form)  # noqa: E731
            per_call, by_name = traced_calls(fn, 20)
            row[form] = {
                "ms": summed_ms(per_call, by_name),
                "call_ms": call_ms(fn),
                "activities": sum(per_call.values()),
                "by_activity_us": {name[:60]: [n, float(np.median(by_name[name]))] for name, n in per_call.items()},
            }
        out[label] = row
    return out


def two_kernel_sketch(M, sk: tuple) -> dict:
    """The served sketch update as it ran before the fused kernel, on the
    same operands: the standalone scan kernel, then phases A and B as torch
    ops (sketch_update_plain with scan=sketch_scan). Its device ms and activities beside the fused kernel's, and its
    glue: its device ms less the scan's. It must give the fused planes."""
    SKK = M.SKK

    def two_kernel():
        return SKK.sketch_update_plain(*sk, scan=SKK.sketch_scan)

    check(same(two_kernel(), SKK.sketch_update_fused(*sk)), "the two-kernel sketch update differs from the fused kernel")
    planes, lo, hi, _weight, _cand, ways = sk
    out = {
        "two_kernel_ms": device_ms(two_kernel),
        "two_kernel_call_ms": call_ms(two_kernel),
        "two_kernel_activities": activities_per_call(two_kernel),
        "scan_ms": device_ms(lambda: SKK.sketch_scan(planes, lo, hi, ways)),
        "fused_ms": device_ms(lambda: SKK.sketch_update_fused(*sk)),
        "fused_call_ms": call_ms(lambda: SKK.sketch_update_fused(*sk)),
        "fused_activities": activities_per_call(lambda: SKK.sketch_update_fused(*sk)),
    }
    out["glue_ms"] = out["two_kernel_ms"] - out["scan_ms"]
    return out


def ptxas_entries(text: str, kernel: str) -> list:
    """`nvcc -Xptxas -v`'s report for each compiled entry whose mangled name
    holds `kernel`: registers, barriers, shared memory, stack and spills,
    one string an entry. Empty when the library came from an earlier
    build."""
    out, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = [line.split("'")[1]] if kernel in line else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and ("spill" in line or "Used" in line):
            cur.append(line.split(" : ", 1)[-1].strip())
    return [" | ".join(c) for c in out]


# -- phase 9: the process that boots (settings, Runner, gRPC, reload) --------

PROCESS_RULES = """\
domain: proc
descriptors:
  - key: user
    rate_limit: {unit: minute, requests_per_unit: 20}
  - key: tenant
    descriptors:
      - key: path
        rate_limit: {unit: hour, requests_per_unit: 400}
  - key: ip
    rate_limit: {unit: second, requests_per_unit: 10}
"""
# the hot reload: the user limit lowered to 2, and a second domain with a
# sliding-window rule
PROCESS_RULES_LOWERED = PROCESS_RULES.replace("requests_per_unit: 20}", "requests_per_unit: 2}")
PROCESS_SLIDING_RULES = """\
domain: slide
descriptors:
  - key: s
    rate_limit: {unit: minute, requests_per_unit: 5, algorithm: sliding_window}
"""
PROCESS_KEYS = 1 << 16  # the stream's Zipf(1.1) universe
PROCESS_V3_CALLS = 4096
PROCESS_V2_CALLS = 64
PROCESS_JSON_CALLS = 64
PROCESS_CLOCK_EVERY = 256  # the fake clock advances every 256 v3 calls
PROCESS_SEQ_CALLS = 512  # the timed sequential run
PROCESS_THREADS = 32
PROCESS_CONCURRENT_CALLS = 2048  # the timed run with 32 client threads
PROCESS_PROFILED_CALLS = 256  # the profiled run with 32 client threads
V3_PATH = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
V2_PATH = "/envoy.service.ratelimit.v2.RateLimitService/ShouldRateLimit"
HEALTH_CHECK_PATH = "/grpc.health.v1.Health/Check"
HEALTH_WATCH_PATH = "/grpc.health.v1.Health/Watch"


def process_env(runtime_root: str, backend: str = "cuda", **overrides) -> dict:
    """The reference's default deployment as environment variables: the
    CUDA engine at 2^22 slots, W picked by the engine (128 on the card),
    the production sketch, the host fast path, direct mode, precompiled,
    on ephemeral ports; `overrides` (variable=value) replace any."""
    env = {
        "BACKEND_TYPE": backend,
        "RUNTIME_ROOT": runtime_root,
        "RUNTIME_SUBDIRECTORY": "ratelimit",
        "USE_STATSD": "false",
        "LOG_LEVEL": "WARN",
        "PORT": "0",
        "GRPC_PORT": "0",
        "DEBUG_PORT": "0",
        "TPU_SLAB_SLOTS": str(N_SLOTS),
        "SLAB_WAYS": "0",
        "HOTKEYS_ENABLED": "true",
        "HOTKEY_LANES": str(HOTKEY_LANES),
        "HOTKEY_K": str(HOTKEY_K),
        "HOST_FAST_PATH": "true",
        "TPU_BATCH_WINDOW": "0",
        "TPU_PRECOMPILE": "true",
    }
    env.update({k: str(v) for k, v in overrides.items()})
    return env


def process_runtime(root: str) -> str:
    """The reference's layout, RUNTIME_ROOT/RUNTIME_SUBDIRECTORY/config/*.yaml;
    returns the config directory."""
    config = os.path.join(root, "ratelimit", "config")
    os.makedirs(config, exist_ok=True)
    write_text(os.path.join(config, "proc.yaml"), PROCESS_RULES)
    return config


def write_text(path: str, text: str) -> None:
    """Write a rule file as a deploy does: into a temporary file beside
    the runtime root (outside the tree the loader reads), then renamed into
    place, so the watcher never reads half a file or a stray copy."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(path))))
    tmp = os.path.join(root, "." + os.path.basename(path) + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def grpc_health(port: int, timeout: float = 5.0) -> int:
    """gRPC health Check's status (or -1 when the call fails)."""
    import grpc
    from api_ratelimit_tpu_torch.pb import health_pb2

    with grpc.insecure_channel(f"localhost:{port}") as ch:
        check = ch.unary_unary(
            HEALTH_CHECK_PATH,
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        try:
            return int(check(health_pb2.HealthCheckRequest(), timeout=timeout).status)
        except grpc.RpcError:
            return -1


def process_boot(env: dict, device: str = "cuda"):
    """Runner(new_settings(env)) booted in process; polls gRPC health until
    SERVING. Returns (runner, seconds from construction to SERVING)."""
    from api_ratelimit_tpu_torch.pb import health_pb2
    from api_ratelimit_tpu_torch.runner import Runner
    from api_ratelimit_tpu_torch.settings import new_settings

    t0 = time.perf_counter()
    runner = Runner(new_settings(env), device=device)
    runner.run_background()
    while grpc_health(runner.server.grpc_port) != health_pb2.HealthCheckResponse.SERVING:
        check(time.perf_counter() - t0 < 120, "the runner never reported SERVING")
        time.sleep(0.01)
    return runner, time.perf_counter() - t0


def process_descriptors(rng, keys: np.ndarray) -> list:
    """One descriptor per key: a user, a (tenant, path) pair or an ip, each
    under its rule."""
    out = []
    for k in keys.tolist():
        kind = k % 3
        if kind == 0:
            out.append([("user", f"u{k}")])
        elif kind == 1:
            out.append([("tenant", f"t{k % 97}"), ("path", f"/p{k}")])
        else:
            out.append([("ip", f"10.{k >> 16}.{(k >> 8) & 255}.{k & 255}")])
    return out


def process_requests(rng, n: int, n_keys: int, kind: str = "v3") -> list:
    """n requests of 1-3 descriptors with Zipf(1.1) keys over n_keys, a
    hits_addend of 0 (one hit) or 1-3 now and then; v3, v2 or /json."""
    from api_ratelimit_tpu_torch.pb import rls_v2, rls_v3

    sizes = rng.integers(1, 4, n)
    descs = process_descriptors(rng, zipf_keys(rng, int(sizes.sum()), n_keys))
    hits = np.where(rng.random(n) < 0.1, rng.integers(1, 4, n), 0)
    out, at = [], 0
    for size, h in zip(sizes.tolist(), hits.tolist()):
        group, at = descs[at : at + size], at + size
        if kind == "json":
            body = {"domain": "proc", "descriptors": [{"entries": [{"key": k, "value": v} for k, v in d]} for d in group]}
            if h:
                body["hitsAddend"] = h
            out.append(json.dumps(body).encode())
            continue
        req = (rls_v3 if kind == "v3" else rls_v2).RateLimitRequest(domain="proc", hits_addend=h)
        for d in group:
            entry = req.descriptors.add()
            for k, v in d:
                entry.entries.add(key=k, value=v)
        out.append(req)
    return out


def raw_caller(channel, path: str):
    """A unary call that returns the response's wire bytes unparsed."""
    return channel.unary_unary(path, request_serializer=lambda m: m.SerializeToString(), response_deserializer=None)


def process_stream(card, host, clock, n_v3: int, n_v2: int, n_json: int, n_keys: int, seed: int = 7) -> dict:
    """The same stream through `card` (BACKEND_TYPE=cuda) and `host`
    (BACKEND_TYPE=memory), one call to each in turn, both on the one fake
    process clock, which advances between calls: every v3 and v2 response
    byte-identical and every /json status and body equal. Returns the
    verdict counts and the descriptors sent."""
    import grpc
    from api_ratelimit_tpu_torch.pb import rls_v3

    rng = np.random.default_rng(seed)
    streams = {
        "v3": process_requests(rng, n_v3, n_keys, "v3"),
        "v2": process_requests(rng, n_v2, n_keys, "v2"),
        "json": process_requests(rng, n_json, n_keys, "json"),
    }
    codes = collections.Counter()
    descriptors = 0
    with grpc.insecure_channel(f"localhost:{card.server.grpc_port}") as cc, grpc.insecure_channel(
        f"localhost:{host.server.grpc_port}"
    ) as hc:
        for kind, path in (("v3", V3_PATH), ("v2", V2_PATH)):
            c_call, h_call = raw_caller(cc, path), raw_caller(hc, path)
            for i, req in enumerate(streams[kind]):
                if kind == "v3" and i and i % PROCESS_CLOCK_EVERY == 0:
                    clock.advance(int(rng.choice([1, 7, 61])))
                got, want = c_call(req, timeout=60), h_call(req, timeout=60)
                check(got == want, f"{kind} call {i}: the card's response differs from the memory backend's")
                descriptors += len(req.descriptors)
                if kind == "v3":
                    codes[rls_v3.RateLimitResponse.Code.Name(rls_v3.RateLimitResponse.FromString(got).overall_code)] += 1
    for i, body in enumerate(streams["json"]):
        got = http_call(card.server.http_port, "POST", "/json", body)
        want = http_call(host.server.http_port, "POST", "/json", body)
        check(got == want, f"/json call {i}: the card's answer differs from the memory backend's: {got} {want}")
        codes[f"json_{got[0]}"] += 1
        descriptors += len(json.loads(body)["descriptors"])
    check(codes["OK"] > 0 and codes["OVER_LIMIT"] > 0, f"the stream did not cross a limit: {dict(codes)}")
    return {"codes": dict(codes), "descriptors": descriptors}


def rlconfig(runner) -> str:
    return http_call(runner.server.debug_port, "GET", "/rlconfig")[1].decode()


def wait_until(pred, what: str, timeout: float = 20.0) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        check(time.perf_counter() < deadline, f"timed out waiting for {what}")
        time.sleep(0.02)


def v3_verdict(port: int, pairs, domain: str = "proc"):
    """One v3 call: (overall code name, [(code name, limit, remaining)])."""
    import grpc
    from api_ratelimit_tpu_torch.pb import rls_grpc, rls_v3

    req = rls_v3.RateLimitRequest(domain=domain)
    entry = req.descriptors.add()
    for k, v in pairs:
        entry.entries.add(key=k, value=v)
    with grpc.insecure_channel(f"localhost:{port}") as ch:
        return verdict_of(rls_grpc.RateLimitServiceV3Stub(ch).ShouldRateLimit(req, timeout=60))


def verdict_of(resp):
    from api_ratelimit_tpu_torch.pb import rls_v3

    name = rls_v3.RateLimitResponse.Code.Name
    return name(resp.overall_code), [
        (name(s.code), s.current_limit.requests_per_unit, s.limit_remaining) for s in resp.statuses
    ]


def process_reload(runner, config_dir: str) -> dict:
    """Hot reload through the runtime watcher: lower the user limit and add
    a sliding-window domain; wait until /rlconfig shows both; the lowered
    limit answers, and a fresh sliding key admits its limit in one window
    and refuses the next call. Then a malformed file (a duplicate domain):
    config_load_error counts it and the reloaded config stays in force."""
    snap = runner.stats_store.debug_snapshot
    loads = snap()["ratelimit.service.config_load_success"]
    write_text(os.path.join(config_dir, "proc.yaml"), PROCESS_RULES_LOWERED)
    write_text(os.path.join(config_dir, "slide.yaml"), PROCESS_SLIDING_RULES)
    wait_until(
        lambda: "slide.s: unit=MINUTE requests_per_unit=5" in rlconfig(runner)
        and "proc.user: unit=MINUTE requests_per_unit=2" in rlconfig(runner),
        "/rlconfig to show the reloaded rules",
    )
    port = runner.server.grpc_port
    lowered = [v3_verdict(port, [("user", "reload-check")]) for _ in range(3)]
    check(
        lowered == [("OK", [("OK", 2, 1)]), ("OK", [("OK", 2, 0)]), ("OVER_LIMIT", [("OVER_LIMIT", 2, 0)])],
        f"the lowered limit did not take effect: {lowered}",
    )
    sliding = [v3_verdict(port, [("s", "one")], domain="slide")[0] for _ in range(6)]
    check(sliding == ["OK"] * 5 + ["OVER_LIMIT"], f"the sliding rule answered {sliding}")
    errors = snap().get("ratelimit.service.config_load_error", 0)
    write_text(os.path.join(config_dir, "broken.yaml"), "domain: proc\n")  # a duplicate domain
    wait_until(lambda: snap().get("ratelimit.service.config_load_error", 0) > errors, "the malformed file's load error")
    kept = v3_verdict(port, [("user", "reload-check-2")])
    check(kept == ("OK", [("OK", 2, 1)]), f"the malformed file displaced the config: {kept}")
    check("slide.s:" in rlconfig(runner), "the malformed file displaced the sliding domain")
    return {"loads": snap()["ratelimit.service.config_load_success"] - loads, "lowered": lowered, "sliding": sliding}


def process_stop(runner) -> dict:
    """runner.stop(): an open health Watch stream gets NOT_SERVING and
    /healthcheck answers 500 while the gRPC grace holds the listeners;
    then every port closes."""
    import grpc
    from api_ratelimit_tpu_torch.pb import health_pb2

    serving, not_serving = health_pb2.HealthCheckResponse.SERVING, health_pb2.HealthCheckResponse.NOT_SERVING
    check(http_call(runner.server.http_port, "GET", "/healthcheck") == (200, b"OK"), "/healthcheck was not 200 OK before stop")
    with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
        watch = ch.unary_stream(
            HEALTH_WATCH_PATH,
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        stream = watch(health_pb2.HealthCheckRequest())
        check(next(stream).status == serving, "health Watch did not start SERVING")
        runner.stop()
        check(next(stream).status == not_serving, "health Watch did not push NOT_SERVING on stop")
        status = http_call(runner.server.http_port, "GET", "/healthcheck")[0]
        check(status == 500, f"/healthcheck answered {status} after stop, before the ports closed")
        stream.cancel()
    check(runner.server.wait_closed(30.0), "the listeners did not close within 30 s of stop")
    for port in (runner.server.http_port, runner.server.debug_port):
        try:
            http_call(port, "GET", "/healthcheck")
        except OSError:
            continue
        check(False, f"port {port} still answers after stop")
    return {"health_failed_before_close": True}


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_module(module: str, args, env: dict, timeout: float = 120.0):
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=timeout
    )


def process_service_cmd(env: dict, in_process_verdict, scratch: str) -> dict:
    """python -m api_ratelimit_tpu_torch.cmd.service_cmd with the same
    environment on fixed ports: it boots (health SERVING), answers
    client_cmd with the in-process runner's verdict, and on SIGTERM pushes
    NOT_SERVING to an open health Watch before it exits 0 within 30 s."""
    import grpc
    from google.protobuf import text_format
    from api_ratelimit_tpu_torch.pb import health_pb2, rls_v3

    http, grpc_port, debug = free_ports(3)
    env = {**os.environ, **env, "PORT": str(http), "GRPC_PORT": str(grpc_port), "DEBUG_PORT": str(debug), "PYTHONPATH": REPO_ROOT}
    out_path = os.path.join(scratch, "service_cmd.log")
    t0 = time.perf_counter()
    with open(out_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "api_ratelimit_tpu_torch.cmd.service_cmd"],
            cwd=REPO_ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        )
    try:
        while grpc_health(grpc_port, timeout=2.0) != health_pb2.HealthCheckResponse.SERVING:
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                with open(out_path) as f:
                    tail = f.read()[-4000:]
                check(False, f"service_cmd never reported SERVING (exit {proc.poll()}):\n{tail}")
            time.sleep(0.1)
        boot_s = time.perf_counter() - t0
        client = run_module(
            "api_ratelimit_tpu_torch.cmd.client_cmd",
            ["-dial_string", f"localhost:{grpc_port}", "-domain", "proc", "-descriptors", "user=client-check"],
            env,
        )
        check(client.returncode == 0, f"client_cmd failed: {client.stderr}")
        resp = text_format.Parse(client.stdout.split("response:", 1)[1], rls_v3.RateLimitResponse())
        check(verdict_of(resp) == in_process_verdict, f"service_cmd answered {verdict_of(resp)}, in process {in_process_verdict}")
        with grpc.insecure_channel(f"localhost:{grpc_port}") as ch:
            watch = ch.unary_stream(
                HEALTH_WATCH_PATH,
                request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
                response_deserializer=health_pb2.HealthCheckResponse.FromString,
            )
            stream = watch(health_pb2.HealthCheckRequest())
            check(next(stream).status == health_pb2.HealthCheckResponse.SERVING, "service_cmd's Watch did not start SERVING")
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            check(
                next(stream).status == health_pb2.HealthCheckResponse.NOT_SERVING,
                "service_cmd did not fail health on SIGTERM",
            )
            stream.cancel()
        rc = proc.wait(timeout=30)
        exit_s = time.perf_counter() - t_term
        check(rc == 0, f"service_cmd exited {rc} on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"boot_s": boot_s, "exit_s": exit_s, "verdict": in_process_verdict}


def process_config_check(config_dir: str) -> dict:
    """config_check_cmd over the runtime's config directory: exit 0, then
    non-zero once a malformed file is there."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    module = "api_ratelimit_tpu_torch.cmd.config_check_cmd"
    ok = run_module(module, ["-config_dir", config_dir], env)
    check(ok.returncode == 0, f"config_check_cmd refused the good config: {ok.stderr}")
    bad = os.path.join(config_dir, "broken.yaml")
    write_text(bad, "domain: proc\n")
    broken = run_module(module, ["-config_dir", config_dir], env)
    os.remove(bad)
    check(broken.returncode != 0 and "error loading config" in broken.stderr, f"config_check_cmd passed a malformed file: {broken}")
    return {"good": ok.returncode, "malformed": broken.returncode}


def grpc_load(port: int, reqs: list, threads: int) -> tuple[float, list]:
    """reqs over `threads` client threads, each with its own channel, one
    call at a time: (wall seconds, per-call seconds)."""
    import grpc

    chunks = [reqs[i::threads] for i in range(threads)]
    lat = [[] for _ in range(threads)]
    start = threading.Barrier(threads + 1)
    errors = []

    def worker(i):
        try:
            with grpc.insecure_channel(f"localhost:{port}") as ch:
                call = raw_caller(ch, V3_PATH)
                call(chunks[i][0], timeout=60)  # connect before the clock starts
                start.wait()
                for req in chunks[i]:
                    t = time.perf_counter()
                    call(req, timeout=60)
                    lat[i].append(time.perf_counter() - t)
        except Exception as e:  # noqa: BLE001 (re-raised by the caller's check)
            errors.append(repr(e))
            start.abort()

    pool = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in pool:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in pool:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"client threads failed: {errors[:3]}")
    return wall, [x for xs in lat for x in xs]


def rate_line(wall: float, lat: list) -> dict:
    return {
        "calls": len(lat),
        "requests_per_s": len(lat) / wall,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
    }


def process_timing(runner, n_keys: int) -> dict:
    """gRPC v3 requests/s and per-call p50/p99: sequential on one channel,
    then 32 client threads; the slab's decisions must rise by the
    descriptors sent; then one profiled run with 32 threads gives the
    device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    decisions = lambda: runner.stats_store.debug_snapshot()["ratelimit.slab.decisions"]  # noqa: E731
    seq_reqs = process_requests(rng, PROCESS_SEQ_CALLS, n_keys)
    before = decisions()
    seq_wall, seq_lat = grpc_load(runner.server.grpc_port, seq_reqs, 1)
    conc_reqs = process_requests(rng, PROCESS_CONCURRENT_CALLS, n_keys)
    conc_wall, conc_lat = grpc_load(runner.server.grpc_port, conc_reqs, PROCESS_THREADS)
    # each thread's first request goes once more, to connect
    sent = sum(len(r.descriptors) for r in seq_reqs + conc_reqs + seq_reqs[:1] + conc_reqs[:PROCESS_THREADS])
    check(decisions() - before == sent, f"the slab counted {decisions() - before} decisions for {sent} descriptors")
    prof_reqs = process_requests(rng, PROCESS_PROFILED_CALLS, n_keys)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prime_trace()
        prof_wall, prof_lat = grpc_load(runner.server.grpc_port, prof_reqs, PROCESS_THREADS)
        torch.cuda.synchronize()
    acts = device_activities(prof)
    check(bool(acts), "the profiled concurrent run recorded no device activity")
    busy_ms = sum(us for _name, us in acts) / 1e3
    return {
        "sequential": rate_line(seq_wall, seq_lat),
        "threads_32": rate_line(conc_wall, conc_lat),
        "profiled_threads_32": rate_line(prof_wall, prof_lat)
        | {"device_ms": busy_ms, "device_busy_share": busy_ms / (prof_wall * 1e3), "device_activities": len(acts)},
    }


def phase_process(K) -> dict:
    """The process that boots: Runner(new_settings(env)) with the default
    deployment against a memory-backend Runner on one fake clock, the
    kernels counted through the served stream, the hot reload, the stop,
    service_cmd and client_cmd in subprocesses and config_check_cmd."""
    import tempfile

    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    t_phase = time.perf_counter()
    steps = {}

    def lap(name: str) -> None:
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_process_") as scratch:
        runtime_root = os.path.join(scratch, "runtime")
        config_dir = process_runtime(runtime_root)
        clock = FakeTimeSource(NOW0)
        install_process_time_source(clock)
        try:
            card, boot_s = process_boot(process_env(runtime_root))
            host, _ = process_boot(process_env(runtime_root, backend="memory"))
            check(card.cache.engine.ways == 128, f"SLAB_WAYS=0 picked {card.cache.engine.ways} ways on the card")
            check(card.cache.engine.precompiled, "TPU_PRECOMPILE=true warmed no launch shape")
            lap("boot")

            K.reset_launch_counts()
            stream = process_stream(card, host, clock, PROCESS_V3_CALLS, PROCESS_V2_CALLS, PROCESS_JSON_CALLS, PROCESS_KEYS)
            launches = dict(K.LAUNCHES)
            forms = dict(K.WAY_SCAN_FORMS)
            check(all(launches[k] > 0 for k in ("way_scan", "slab_apply", "sketch_update")), f"the runner skipped a kernel: {launches}")
            check(
                launches["way_scan"] == launches["slab_apply"] == launches["sketch_update"]
                and launches["sketch_scan"] == 0 and sum(K.WAY_SCAN_MULTI_FORMS.values()) == 0,
                f"the served launches do not run one of each kernel: {launches}",
            )
            check(sum(forms.values()) == launches["way_scan"], f"way scan forms {forms} against {launches['way_scan']} launches")
            slab = {k: v for k, v in card.stats_store.debug_snapshot().items() if k.startswith("ratelimit.slab.")}
            check(
                slab["ratelimit.slab.evictions.live"] == slab["ratelimit.slab.evictions.window"] == slab["ratelimit.slab.drops"] == 0,
                f"evictions of live rows at 2^22 slots: {slab}",
            )
            check(slab["ratelimit.slab.decisions"] == stream["descriptors"], f"the slab decided {slab['ratelimit.slab.decisions']} of {stream['descriptors']} descriptors")
            lap("stream")

            timing = process_timing(card, PROCESS_KEYS)
            lap("timing")

            K.reset_launch_counts()
            reload = process_reload(card, config_dir)
            multi = sum(K.WAY_SCAN_MULTI_FORMS.values())
            check(multi > 0 and card.cache.engine.algos_seen, f"the sliding rule ran no multi-algorithm way scan: {dict(K.WAY_SCAN_MULTI_FORMS)}")
            loads = card.stats_store.debug_snapshot()["ratelimit.service.config_load_success"]
            os.remove(os.path.join(config_dir, "broken.yaml"))
            wait_until(
                lambda: card.stats_store.debug_snapshot()["ratelimit.service.config_load_success"] > loads,
                "the reload once the malformed file went",
            )
            lap("reload")
            check_cmd = process_config_check(config_dir)
            lap("config_check_cmd")
            verdict = v3_verdict(card.server.grpc_port, [("user", "client-check")])
            stop = process_stop(card)
            host.stop()
            lap("stop")
            subprocess_run = process_service_cmd(process_env(runtime_root), verdict, scratch)
            lap("service_cmd")
        finally:
            install_process_time_source(RealTimeSource())
    out = {
        "boot_s": boot_s,
        "launches": {k: launches[k] for k in ("way_scan", "slab_apply", "sketch_update")},
        "way_scan_forms": forms,
        "multi_way_scans_after_reload": multi,
        "stream": stream,
        "slab": {k.removeprefix("ratelimit.slab."): v for k, v in slab.items()},
        "grpc": timing,
        "reload": {"sliding": reload["sliding"], "lowered": reload["lowered"]},
        "stop": stop,
        "service_cmd": subprocess_run,
        "config_check_cmd": check_cmd,
        "phase_s": time.perf_counter() - t_phase,
        "step_s": steps,
    }
    log(
        f"process: boot {boot_s:.2f} s, launches {out['launches']}, stream {stream['codes']}, "
        f"sequential {timing['sequential']['requests_per_s']:.0f}/s, 32 threads {timing['threads_32']['requests_per_s']:.0f}/s, "
        f"busy {timing['profiled_threads_32']['device_busy_share']:.4f}, service_cmd boot {subprocess_run['boot_s']:.1f} s "
        f"exit {subprocess_run['exit_s']:.2f} s ({out['phase_s']:.1f} s)"
    )
    return out


# -- phase 10: observability and shedding around the engine ------------------

OBS_CALLS = 1024  # the verdict stream, v3 calls of 1-3 descriptors
OBS_WINDOW = "200us"  # the windowed runner's TPU_BATCH_WINDOW
OBS_WINDOW_THREADS = 8
OBS_WINDOW_CALLS = 256
OBS_PROFILE_MS = 500  # the /debug/profile capture
OBS_CAPTURES = 5  # captures in a row, every one naming the served kernels (C10)
OBS_TIMED_CALLS = 512  # each arm's calls in the cost comparison
OBS_COST_BLOCK = 16  # the calls an arm serves before the other takes its turn
OBS_PROFILED_CALLS = 64  # each profiled run of the cost comparison: the busy share
OBS_KERNELS = ("way_scan_kernel", "slab_apply_kernel", "sketch_update_kernel")
OBS_TRACE_ID = 0xC0FFEE  # the hot-key check call's B3 trace id


class ZipkinCollector:
    """A Zipkin v2 collector on 127.0.0.1: records every POSTed span batch.
    stop() closes it."""

    def __init__(self):
        import http.server

        self.spans: list = []
        lock = threading.Lock()
        spans = self.spans

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                batch = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                with lock:
                    spans.extend(batch)
                self.send_response(202)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *_a):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, name="zipkin-collector", daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._server.server_port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(10)


def obs_tracing(collector) -> dict:
    """The tracer's variables: on, exporting to the phase's collector."""
    return {"K_TRACING_ENABLED": "true", "K_TRACING_ZIPKIN_URL": collector.url}


def obs_register(runner=None) -> None:
    """Make `runner`'s tracer and journey recorder the process's (None: the
    no-op tracer and no recorder). The tracer and the recorder are process
    globals, as in the reference: with several runners in one process, the
    one registered last serves every runner, so this phase registers the
    runner it is about to call before each call or run."""
    from api_ratelimit_tpu_torch.tracing import NoopTracer, journeys, set_global_tracer

    set_global_tracer(runner.tracer if runner is not None else NoopTracer())
    journeys.set_global_recorder(runner.journeys if runner is not None else None)


def descriptor_hits(reqs: list) -> tuple[int, collections.Counter]:
    """The hits a stream of v3 requests adds, and the hits per descriptor."""
    per = collections.Counter()
    for req in reqs:
        for d in req.descriptors:
            per[tuple((e.key, e.value) for e in d.entries)] += max(1, req.hits_addend)
    return sum(per.values()), per


def obs_stream(card, host, clock, n_calls: int, n_keys: int, seed: int = 13) -> dict:
    """n_calls v3 calls through `card` (observability registered) and
    `host` (the memory backend, nothing registered), one to each in turn on
    the one fake clock: every response byte-identical."""
    import grpc

    rng = np.random.default_rng(seed)
    reqs = process_requests(rng, n_calls, n_keys)
    with grpc.insecure_channel(f"localhost:{card.server.grpc_port}") as cc, grpc.insecure_channel(
        f"localhost:{host.server.grpc_port}"
    ) as hc:
        c_call, h_call = raw_caller(cc, V3_PATH), raw_caller(hc, V3_PATH)
        for i, req in enumerate(reqs):
            if i and i % PROCESS_CLOCK_EVERY == 0:
                clock.advance(int(rng.choice([1, 7, 61])))
            obs_register(card)
            got = c_call(req, timeout=60)
            obs_register(None)
            want = h_call(req, timeout=60)
            check(got == want, f"observability stream call {i}: the card's response differs from the memory backend's")
    obs_register(card)
    hits, per = descriptor_hits(reqs)
    return {"calls": n_calls, "hits": hits, "descriptors": sum(len(r.descriptors) for r in reqs), "hottest": per.most_common(1)[0][0]}


def obs_counters(runner) -> dict:
    """The ladder's and the shed's counters and gauge."""
    snap = runner.stats_store.debug_snapshot()
    keys = [f"ratelimit.fallback.{k}" for k in ("allow", "deny", "degraded")] + ["ratelimit.overload.shed"]
    return {k: snap.get(k, 0) for k in keys}


def obs_metrics(runner, hits: int, platform_id: int, device_count: int) -> dict:
    """GET /metrics parses as the text exposition with no line dropped; the
    rules' total_hits counters sum to the stream's hits; the build gauges
    name the card."""
    from api_ratelimit_tpu_torch.stats import prometheus

    status, body = http_call(runner.server.debug_port, "GET", "/metrics")
    check(status == 200, f"/metrics answered {status}")
    report: dict = {}
    types_, families = prometheus.parse_exposition(body.decode(), report)
    check(report["dropped_lines"] == 0, f"/metrics held {report['dropped_lines']} unparseable lines")
    check(all(types_.get(name) for name in families), "a /metrics sample has no TYPE line")
    total_hits = sum(
        v for name, samples in families.items()
        if name.startswith("ratelimit_service_rate_limit_") and name.endswith("_total_hits")
        for v in samples.values()
    )
    check(total_hits == hits, f"/metrics counts {total_hits} hits, the stream sent {hits}")
    build = {name: next(iter(s.values())) for name, s in families.items() if name.startswith("ratelimit_build_")}
    check(
        (build["ratelimit_build_platform_id"], build["ratelimit_build_device_count"]) == (platform_id, device_count),
        f"the build gauges say {build}",
    )
    check(prometheus.CONTENT_TYPE.startswith("text/plain; version=0.0.4"), "the exposition content type moved")
    return {"families": len(families), "total_hits": total_hits, "build": build}


def stage_order_ok(stages: dict, order) -> bool:
    """The journey holds every stage of `order`, stamped in that order."""
    return all(s in stages for s in order) and [stages[s] for s in order] == sorted(stages[s] for s in order)


def obs_journeys(runner) -> dict:
    """GET /debug/journeys: retained journeys, each holding the pipeline's
    stages in the reference's order (tracing/journeys.py STAGES, held equal
    to the JAX package's by tests/test_torch_journeys.py)."""
    from api_ratelimit_tpu_torch.tracing import journeys

    doc = json.loads(http_call(runner.server.debug_port, "GET", "/debug/journeys")[1])
    check(doc["enabled"] and doc["retained"], "/debug/journeys retained no journey")
    device = [j for j in doc["retained"] if "publish" in j["stages"]]
    check(device, "no retained journey reached the engine")
    bad = [j for j in device if not stage_order_ok(j["stages"], journeys.STAGES)]
    check(not bad, f"journeys with stages out of order: {bad[:2]}")
    flags = collections.Counter(f for j in doc["retained"] for f in j["flags"])
    return {"retained": len(doc["retained"]), "flags": dict(flags)}


def obs_hotkey(runner, hottest) -> dict:
    """After a stats flush drains the sketch, one call on the stream's
    hottest descriptor carries FLAG_HOTKEY in its journey."""
    import grpc
    from api_ratelimit_tpu_torch.pb import rls_v3

    runner.stats_store.flush()  # HotkeyStats: the drain
    check(runner.cache.engine.hot_fps, "the drain ranked no key hot")
    req = rls_v3.RateLimitRequest(domain="proc")
    entry = req.descriptors.add()
    for k, v in hottest:
        entry.entries.add(key=k, value=v)
    meta = [("x-b3-traceid", f"{OBS_TRACE_ID:032x}"), ("x-b3-spanid", f"{OBS_TRACE_ID:016x}"), ("x-b3-sampled", "1")]
    with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
        raw_caller(ch, V3_PATH)(req, timeout=60, metadata=meta)
    doc = json.loads(http_call(runner.server.debug_port, "GET", "/debug/journeys")[1])
    mine = [j for j in doc["retained"] if j["trace_id"] == f"{OBS_TRACE_ID:032x}"]
    check(mine and "hotkey" in mine[-1]["flags"], f"the hottest descriptor's call was not flagged hotkey: {mine}")
    return {"hot_keys": len(runner.cache.engine.hot_fps), "flags": mine[-1]["flags"]}


def obs_collector_spans(collector, want: int, timeout: float = 15.0) -> dict:
    """The Zipkin collector received one server span for each sampled v3
    call (the exporter flushes once a second)."""
    deadline = time.perf_counter() + timeout

    def server_spans():
        return [s for s in list(collector.spans) if s["name"] == V3_PATH and s["tags"].get("span.kind") == "server"]

    while len(server_spans()) < want and time.perf_counter() < deadline:
        time.sleep(0.1)
    got = server_spans()
    check(len(got) == want, f"the collector holds {len(got)} server spans for {want} calls")
    return {"server_spans": len(got), "spans": len(collector.spans)}


def obs_windowed(env: dict, n_keys: int, device: str = "cuda", on_boot=None) -> dict:
    """The windowed arm (TPU_BATCH_WINDOW > 0, the dispatch loop) with the
    in-process recording tracer: 8 client threads; /debug/traces holds a
    server span for each call, dispatch.batch spans link exactly those
    request spans, each request span has its dispatch.* stage children, and
    every journey holds the batcher and owner stages in order. on_boot()
    runs once the runner serves (the launch counters' reset); returns the
    batches launched."""
    from api_ratelimit_tpu_torch.tracing import journeys

    runner, boot_s = process_boot(dict(env, TPU_BATCH_WINDOW=OBS_WINDOW, K_TRACING_ENABLED="true"), device=device)
    try:
        obs_register(runner)
        loop = runner.cache.engine.dispatch_loop
        check(loop is not None, "TPU_BATCH_WINDOW > 0 built no dispatch loop")
        if on_boot is not None:
            on_boot()
        launches0 = loop.launches
        rng = np.random.default_rng(17)
        reqs = process_requests(rng, OBS_WINDOW_CALLS, n_keys)
        grpc_load(runner.server.grpc_port, reqs, OBS_WINDOW_THREADS)
        calls = OBS_WINDOW_CALLS + OBS_WINDOW_THREADS  # each thread's connecting call
        batches = loop.launches - launches0
        spans = json.loads(http_call(runner.server.debug_port, "GET", "/debug/traces")[1])["spans"]
        server = {s["span_id"] for s in spans if s["operation_name"] == V3_PATH}
        check(len(server) == calls, f"/debug/traces holds {len(server)} server spans for {calls} calls")
        batch = [s for s in spans if s["operation_name"] == "dispatch.batch"]
        linked = {link["span_id"] for s in batch for link in s["links"]}
        check(linked == server, f"the batch spans link {len(linked)} request spans of {len(server)}")
        staged = collections.Counter(s["parent_id"] for s in spans if s["operation_name"].startswith("dispatch.") and s["parent_id"])
        check(all(staged[sid] == 4 for sid in server), "a request span lacks its four dispatch.* stage spans")
        doc = json.loads(http_call(runner.server.debug_port, "GET", "/debug/journeys")[1])
        recent = [j for ring in doc["recent"].values() for j in ring]
        check(recent and all(stage_order_ok(j["stages"], journeys.STAGES) for j in recent), "a windowed journey lacks the batcher and owner stages in order")
        return {
            "boot_s": boot_s, "calls": calls, "batches": batches, "batch_spans": len(batch),
            "max_links": max(len(s["links"]) for s in batch), "journeys": len(recent),
        }
    finally:
        runner.stop()


def trace_kernel_names(profile_dir: str, names) -> dict:
    """How often each of `names` appears in the Chrome trace(s) under
    profile_dir."""
    text = ""
    for f in sorted(os.listdir(profile_dir)):
        with open(os.path.join(profile_dir, f)) as fh:
            text += fh.read()
    return {name: text.count(name) for name in names}


def obs_device_trace(runner, profile_dir: str, n_keys: int, kernels=OBS_KERNELS) -> dict:
    """GET /debug/profile?ms=500 while a client thread drives calls: 200
    and {profile_dir, ms}; a second capture during the first answers 429;
    then OBS_CAPTURES - 1 more captures in a row under the same load. Each
    capture's trace (one file a capture) must name every served kernel
    (C10: each capture's counts are printed; nothing is retried)."""
    rng = np.random.default_rng(19)
    reqs = process_requests(rng, 4096, n_keys)
    stop = threading.Event()
    sent = [0]
    errors = []

    def drive():
        import grpc

        try:
            with grpc.insecure_channel(f"localhost:{runner.server.grpc_port}") as ch:
                call = raw_caller(ch, V3_PATH)
                for req in reqs:
                    if stop.is_set():
                        break
                    call(req, timeout=60)
                    sent[0] += 1
        except Exception as e:  # noqa: BLE001 (re-raised by the check below)
            errors.append(repr(e))

    result = {}

    def capture():
        result["first"] = http_call(runner.server.debug_port, "GET", f"/debug/profile?ms={OBS_PROFILE_MS}")

    driver = threading.Thread(target=drive, name="obs-driver")
    capturer = threading.Thread(target=capture, name="obs-capture")
    driver.start()
    time.sleep(0.2)
    capturer.start()
    time.sleep(OBS_PROFILE_MS / 1e3 / 4)
    second = http_call(runner.server.debug_port, "GET", "/debug/profile?ms=10")
    capturer.join(120)
    captures = [{"calls_during": sent[0], **trace_counts_of_new(profile_dir, set(), kernels)}]
    for _ in range(OBS_CAPTURES - 1):
        seen, calls0 = set(os.listdir(profile_dir)), sent[0]
        status, body = http_call(runner.server.debug_port, "GET", f"/debug/profile?ms={OBS_PROFILE_MS}")
        check(status == 200 and json.loads(body) == {"profile_dir": profile_dir, "ms": float(OBS_PROFILE_MS)},
              f"/debug/profile answered {status}: {body[:200]}")
        captures.append({"calls_during": sent[0] - calls0, **trace_counts_of_new(profile_dir, seen, kernels)})
    stop.set()
    driver.join(120)
    check(not errors, f"the client thread failed: {errors}")
    check(not capturer.is_alive() and not driver.is_alive(), "the capture or the client thread hung")
    status, body = result["first"]
    check(status == 200, f"/debug/profile answered {status}: {body[:200]}")
    doc = json.loads(body)
    check(doc == {"profile_dir": profile_dir, "ms": float(OBS_PROFILE_MS)}, f"/debug/profile answered {doc}")
    check(second[0] == 429, f"a second capture during the first answered {second[0]}")
    for i, c in enumerate(captures):
        log(f"10 capture {i + 1}/{OBS_CAPTURES}: {c['kernels']} kernels, served {c['served']}, {c['calls_during']} calls")
    for i, c in enumerate(captures):
        check(c["calls_during"] > 0, f"capture {i + 1} ran with no call in flight")
        check(all(c["served"].values()), f"capture {i + 1}/{OBS_CAPTURES}'s device trace misses a served kernel: {c['served']}")
    counts = trace_kernel_names(profile_dir, kernels)
    return {"calls_during": sent[0], "kernel_mentions": counts, "second_capture": second[0],
            "files": len(os.listdir(profile_dir)), "captures": captures}


def trace_counts_of_new(profile_dir: str, seen: set, kernels) -> dict:
    """The one trace file in profile_dir not in `seen`: its kernel count and
    each of `kernels`' count."""
    new = sorted(set(os.listdir(profile_dir)) - seen)
    check(len(new) == 1, f"a capture wrote {len(new)} trace files")
    with open(os.path.join(profile_dir, new[0])) as f:
        events = json.load(f).get("traceEvents", [])
    names = [str(ev.get("name", "")) for ev in events if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() == "kernel"]
    return {"kernels": len(names), "served": {k: sum(k in n for n in names) for k in kernels}}


def obs_busy(runner, reqs: list) -> float:
    """The card's busy share of the wall time of reqs, sequential on one
    channel, under torch.profiler (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prime_trace()
        wall, _lat = grpc_load(runner.server.grpc_port, reqs, 1)
        torch.cuda.synchronize()
    return sum(us for _name, us in device_activities(prof)) / 1e3 / (wall * 1e3)


def obs_cost(on, off, n_keys: int, profiled: bool = True) -> dict:
    """Sequential gRPC v3 requests/s, p50 and p99 with tracing, journeys
    and exemplars on (runner `on`, the phase's tracer and recorder) and off
    (runner `off`: the no-op tracer, no recorder), two runners booted alike
    for this comparison and warmed on the same calls. The arms take turns
    over one request list, OBS_COST_BLOCK calls at a time in A B B A order,
    each serving the same calls, so a drift within the process falls on
    both alike; the gap is kept with its spread over the block pairs. Then,
    when `profiled`, the card's busy share of four profiled runs of
    OBS_PROFILED_CALLS in A B B A order. Printed, not claimed: only these
    runs compare with one another."""
    import grpc

    arms = {"on": on, "off": off}
    rng = np.random.default_rng(23)
    warm = process_requests(rng, 4 * OBS_COST_BLOCK, n_keys)
    reqs = process_requests(rng, OBS_TIMED_CALLS, n_keys)
    lat = {"on": [], "off": []}
    blocks = []  # (on, off) mean call ms of each block pair
    with contextlib.ExitStack() as stack:
        calls = {}
        for arm, runner in arms.items():
            channel = stack.enter_context(grpc.insecure_channel(f"localhost:{runner.server.grpc_port}"))
            calls[arm] = raw_caller(channel, V3_PATH)

        def serve(arm: str, block: list) -> list:
            obs_register(arms[arm])
            out = []
            for req in block:
                t0 = time.perf_counter()
                calls[arm](req, timeout=60)
                out.append(time.perf_counter() - t0)
            return out

        for arm in arms:
            serve(arm, warm)
        for b, at in enumerate(range(0, OBS_TIMED_CALLS, OBS_COST_BLOCK)):
            block = reqs[at : at + OBS_COST_BLOCK]
            mean = {}
            for arm in ("on", "off") if b % 2 == 0 else ("off", "on"):
                took = serve(arm, block)
                lat[arm] += took
                mean[arm] = sum(took) / len(took) * 1e3
            blocks.append((mean["on"], mean["off"]))
    obs_register(None)
    gaps = np.array([a - b for a, b in blocks])
    ratios = np.array([a / b for a, b in blocks])
    out = {
        "block": OBS_COST_BLOCK,
        "arms": {arm: rate_line(sum(lat[arm]), lat[arm]) for arm in arms},
        "gap_ms": {q: float(np.percentile(gaps, p)) for q, p in (("p10", 10), ("p50", 50), ("p90", 90))},
        "ratio": {q: float(np.percentile(ratios, p)) for q, p in (("p10", 10), ("p50", 50), ("p90", 90))},
    }
    if profiled:
        prof_reqs = process_requests(rng, OBS_PROFILED_CALLS, n_keys)
        busy = []
        for arm in ("on", "off", "off", "on"):
            obs_register(arms[arm])
            busy.append({"arm": arm, "device_busy_share": obs_busy(arms[arm], prof_reqs)})
        obs_register(None)
        out["busy"] = busy
    return out


def phase_observability(K) -> dict:
    """Observability and shedding around the served engine (module
    docstring, phase 10)."""
    import tempfile

    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    t_phase = time.perf_counter()
    steps = {}

    def lap(name: str) -> None:
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    runners = []
    collector = ZipkinCollector()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as scratch:
        runtime_root = os.path.join(scratch, "runtime")
        process_runtime(runtime_root)
        profile_dir = os.path.join(scratch, "profiles")
        clock = FakeTimeSource(NOW0)
        install_process_time_source(clock)
        try:
            env = process_env(
                runtime_root, FAILURE_MODE_DENY="deny", OVERLOAD_SHED_MODE="allow", TPU_PROFILE_DIR=profile_dir
            )
            host, _ = process_boot(process_env(runtime_root, backend="memory", JOURNEY_RECORDER_ENABLED="false"))
            runners.append(host)
            card, boot_s = process_boot(dict(env, **obs_tracing(collector)))
            runners.append(card)
            check(card.settings.debug_metrics_enabled and card.journeys is not None, "the defaults did not turn on /metrics and the recorder")
            check(card.fallback is not None and card.overload.shed_mode == "allow", "the ladder or the allow posture is missing")
            lap("boot")

            K.reset_launch_counts()
            stream = obs_stream(card, host, clock, OBS_CALLS, PROCESS_KEYS)
            launches = {k: K.LAUNCHES[k] for k in ("way_scan", "slab_apply", "sketch_update")}
            check(all(v == OBS_CALLS for v in launches.values()), f"{OBS_CALLS} calls launched {launches}")
            metrics = obs_metrics(card, stream["hits"], 2, 1)
            journey_doc = obs_journeys(card)
            spans = obs_collector_spans(collector, OBS_CALLS)
            hot = obs_hotkey(card, stream["hottest"])
            lap("stream")

            trace = obs_device_trace(card, profile_dir, PROCESS_KEYS)
            lap("device_trace")
            counters = obs_counters(card)
            check(not any(counters.values()), f"the ladder or the shed answered while the card served: {counters}")
            health = http_call(card.server.http_port, "GET", "/healthcheck")
            check(health == (200, b"OK"), f"/healthcheck answered {health} while the card served")

            windowed = obs_windowed(env, PROCESS_KEYS, on_boot=K.reset_launch_counts)
            windowed["launches"] = {k: K.LAUNCHES[k] for k in ("way_scan", "slab_apply", "sketch_update")}
            check(
                all(v == windowed["batches"] for v in windowed["launches"].values()),
                f"{windowed['batches']} batches launched {windowed['launches']}",
            )
            lap("windowed")

            on, _ = process_boot(dict(env, **obs_tracing(collector)))
            runners.append(on)
            off, _ = process_boot(dict(env, JOURNEY_RECORDER_ENABLED="false"))
            runners.append(off)
            cost = obs_cost(on, off, PROCESS_KEYS)
            lap("cost")
            counters = obs_counters(card)
            check(not any(counters.values()), f"the ladder or the shed answered while the card served: {counters}")
        finally:
            obs_register(None)
            for r in runners:
                r.stop()
            collector.stop()
            install_process_time_source(RealTimeSource())
    check(
        not any(t.name == "tracing-flush" and t.is_alive() for t in threading.enumerate()),
        "the tracer's exporter thread outlived Runner.stop()",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
    )
    out = {
        "boot_s": boot_s,
        "launches": launches,
        "stream": {k: v for k, v in stream.items() if k != "hottest"},
        "fallback_and_shed": counters,
        "metrics": metrics,
        "journeys": journey_doc,
        "hotkey": hot,
        "collector": spans,
        "device_trace": trace,
        "windowed": windowed,
        "cost": cost,
        "card": smi.stdout.strip(),
        "phase_s": time.perf_counter() - t_phase,
        "step_s": steps,
    }
    arms = cost["arms"]
    log(
        "observability: " + ", ".join(
            f"{arm} {r['requests_per_s']:.1f}/s p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms" for arm, r in arms.items()
        ) + f"; on-off per block {cost['gap_ms']['p50']:.3f} ms (p10 {cost['gap_ms']['p10']:.3f}, p90 {cost['gap_ms']['p90']:.3f}); busy "
        + " ".join(f"{b['arm']} {b['device_busy_share']:.4f}" for b in cost.get("busy", [])) + f" ({out['phase_s']:.1f} s)"
    )
    return out


# -- phase 11: warm restart and the redis oracle ------------------------------

WARM_CALLS = 1024  # v3 calls before the drain handoff, and as many after it
WARM_SNAPSHOT_MS = 3_600_000  # the periodic snapshot never fires in a step
CRASH_CALLS = 1000  # calls before the crash; snapshot_once every CRASH_EVERY
CRASH_EVERY = 256
CRASH_AFTER = 512  # calls after the crash restore
UNDER_THREADS = 8  # client threads of the snapshot-under-traffic step
UNDER_SNAPSHOTS = 5
UNDER_GAP_S = 0.4  # traffic without a snapshot in flight, between snapshots
UNDER_BATCH = 65536
UNDER_KEYS = 1 << 20
REDIS_CALLS = 1024


def warm_env(runtime_root: str, snap_dir: str, **overrides) -> dict:
    """Phase 9's deployment with SLAB_SNAPSHOT_DIR set."""
    return process_env(
        runtime_root, SLAB_SNAPSHOT_DIR=snap_dir, SLAB_SNAPSHOT_INTERVAL_MS=WARM_SNAPSHOT_MS, **overrides
    )


def warm_stream(seed: int, n: int) -> tuple[list, list]:
    """n v3 requests (1-3 descriptors, Zipf(1.1) over PROCESS_KEYS) and the
    fake clock's advance before each (1, 7 or 61 s every
    PROCESS_CLOCK_EVERY calls, else 0)."""
    rng = np.random.default_rng(seed)
    reqs = process_requests(rng, n, PROCESS_KEYS)
    steps = [int(rng.choice([1, 7, 61])) if i and i % PROCESS_CLOCK_EVERY == 0 else 0 for i in range(n)]
    return reqs, steps


def warm_calls(runners: list, clock, reqs: list, steps: list, lo: int, hi: int) -> list:
    """Calls lo..hi-1 of the stream through each runner in turn, the clock
    advancing by the stream's steps; each runner's response bytes."""
    import grpc

    channels = [grpc.insecure_channel(f"localhost:{r.server.grpc_port}") for r in runners]
    try:
        calls = [raw_caller(ch, V3_PATH) for ch in channels]
        out = [[] for _ in runners]
        for i in range(lo, hi):
            if steps[i]:
                clock.advance(steps[i])
            for j, call in enumerate(calls):
                out[j].append(call(reqs[i], timeout=60))
    finally:
        for ch in channels:
            ch.close()
    return out


def served_launches(K) -> dict:
    return {k: K.LAUNCHES[k] for k in ("way_scan", "slab_apply", "sketch_update")}


def warm_handoff(K, runtime_root: str, scratch: str, clock, device: str, overrides: dict, keep: bool = False) -> dict:
    """Step 1: runner A serves WARM_CALLS calls beside a memory runner and
    stops (the drain snapshot); runner B boots from A's file and serves the
    next WARM_CALLS calls, each response byte-identical to the memory
    runner's, which never restarted; the kernels launch once a call. keep:
    copy A's slab.snap out of the scratch directory for phase 16's
    inspector ("kept": its path, the restore's now and B's restored rows)."""
    import shutil
    import tempfile

    from api_ratelimit_tpu_torch.persist.snapshot import HEADER_SIZE, load_snapshot, reconcile_rows

    snap_dir = os.path.join(scratch, "handoff")
    reqs, steps = warm_stream(23, 2 * WARM_CALLS)
    host, _ = process_boot(process_env(runtime_root, backend="memory"), device=device)
    runners = [host]
    try:
        a, boot_a = process_boot(warm_env(runtime_root, snap_dir, **overrides), device=device)
        runners.append(a)
        check(a.snapshotter.restore_stats == {"restored": False, "reason": "no snapshot"}, "runner A found a snapshot")
        got, want = warm_calls([a, host], clock, reqs, steps, 0, WARM_CALLS)
        check(got == want, "runner A's responses differ from the memory runner's")
        runners.remove(a)
        a.stop()
        path = os.path.join(snap_dir, "slab.snap")
        n_slots = a.cache.engine.shard_slots
        size = os.path.getsize(path)
        check(size == HEADER_SIZE + n_slots * 32, f"slab.snap is {size} bytes for {n_slots} slots")
        header, table = load_snapshot(path)
        last = a.cache.engine.export_tables()[0]
        check(np.array_equal(table, last), "the drain snapshot's payload differs from the engine's last export")
        check(header.ways == a.cache.engine.ways, f"the header stamps {header.ways} ways")
        live = reconcile_rows(last, int(clock.unix_now()))[1]["restored"]
        check(live > 0, "runner A left no live row")
        del a
        kept = None
        if keep:
            kept = {"path": os.path.join(tempfile.mkdtemp(prefix="chip_smoke_kept_"), "slab.snap"),
                    "now": int(clock.unix_now()), "restored": live}
            shutil.copyfile(path, kept["path"])

        t0 = time.perf_counter()
        b, boot_b = process_boot(warm_env(runtime_root, snap_dir, **overrides), device=device)
        runners.append(b)
        restored = b.snapshotter.restore_stats
        check(restored.get("restored") == live, f"runner B restored {restored} of A's {live} live rows")
        K.reset_launch_counts()
        got, want = warm_calls([b, host], clock, reqs, steps, WARM_CALLS, 2 * WARM_CALLS)
        launches = served_launches(K)
        check(got == want, "runner B's responses differ from the memory runner that never restarted")
        if device == "cuda":
            check(all(v == WARM_CALLS for v in launches.values()), f"{WARM_CALLS} calls after the restore launched {launches}")
        check(not b.cache.engine.algos_seen, "the fixed-window rules flipped the guard")
    finally:
        for r in runners:
            r.stop()
    return {
        "snapshot_bytes": size,
        "live_rows": live,
        "restore_stats": restored,
        "boot_s": {"a": boot_a, "b": boot_b},
        "launches_after_restore": launches,
        **({"kept": kept} if keep else {}),
    }


def verdicts(raw: bytes) -> list:
    from api_ratelimit_tpu_torch.pb import rls_v3

    return [int(s.code) for s in rls_v3.RateLimitResponse.FromString(raw).statuses]


def descriptor_keys(req) -> list:
    return [tuple((e.key, e.value) for e in d.entries) for d in req.descriptors]


def warm_crash(K, runtime_root: str, scratch: str, clock, device: str, overrides: dict) -> dict:
    """Step 2: runner C snapshots every CRASH_EVERY calls and is abandoned
    CRASH_CALLS calls in, without a drain; runner D restores and serves
    CRASH_AFTER more. Against a memory runner that served every call, every
    disagreement of D admits where the memory runner refuses (never the
    other way), at most as often for a key as the key's hits the crash
    lost."""
    from api_ratelimit_tpu_torch.pb import rls_v3

    ok, over = rls_v3.RateLimitResponse.OK, rls_v3.RateLimitResponse.OVER_LIMIT
    snap_dir = os.path.join(scratch, "crash")
    reqs, steps = warm_stream(29, CRASH_CALLS + CRASH_AFTER)
    host, _ = process_boot(process_env(runtime_root, backend="memory"), device=device)
    runners = [host]
    try:
        c, _ = process_boot(warm_env(runtime_root, snap_dir, **overrides), device=device)
        runners.append(c)
        last_snapshot = 0
        for lo in range(0, CRASH_CALLS, CRASH_EVERY):
            hi = min(lo + CRASH_EVERY, CRASH_CALLS)
            got, want = warm_calls([c, host], clock, reqs, steps, lo, hi)
            check(got == want, f"runner C's calls {lo}..{hi} differ from the memory runner's")
            if hi - lo == CRASH_EVERY:
                check(c.snapshotter.snapshot_once() > 0, "snapshot_once failed")
                last_snapshot = hi
        # abandoned: no drain, no final snapshot (stop() below skips it)
        snapshotter, c.snapshotter = c.snapshotter, None
        snapshotter.stop()
        lost = collections.Counter()
        for req in reqs[last_snapshot:CRASH_CALLS]:
            for key in descriptor_keys(req):
                lost[key] += max(1, req.hits_addend)

        d, _ = process_boot(warm_env(runtime_root, snap_dir, **overrides), device=device)
        runners.append(d)
        restored = d.snapshotter.restore_stats
        check(restored.get("restored", 0) > 0, f"runner D restored nothing: {restored}")
        K.reset_launch_counts()
        got, want = warm_calls([d, host], clock, reqs, steps, CRASH_CALLS, CRASH_CALLS + CRASH_AFTER)
        launches = served_launches(K)
        over_admits, over_refusals = collections.Counter(), 0
        for req, g, w in zip(reqs[CRASH_CALLS:], got, want):
            for key, gc, wc in zip(descriptor_keys(req), verdicts(g), verdicts(w)):
                if gc == ok and wc == over:
                    over_admits[key] += 1
                elif gc != wc:
                    over_refusals += 1
        check(over_refusals == 0, f"the crash restore refused {over_refusals} decisions the memory runner admitted")
        beyond = {k: (n, lost[k]) for k, n in over_admits.items() if n > lost[k]}
        check(not beyond, f"over-admission past the lost hits: {dict(list(beyond.items())[:5])}")
        if device == "cuda":
            check(all(v == CRASH_AFTER for v in launches.values()), f"{CRASH_AFTER} calls after the restore launched {launches}")
    finally:
        for r in runners:
            r.stop()
    return {
        "last_snapshot_call": last_snapshot,
        "lost_calls": CRASH_CALLS - last_snapshot,
        "lost_hits": sum(lost.values()),
        "restore_stats": restored,
        "false_over": over_refusals,
        "over_admits": sum(over_admits.values()),
        "max_over_admits_per_key": max(over_admits.values(), default=0),
        "identical_responses": sum(g == w for g, w in zip(got, want)),
        "launches_after_restore": launches,
    }


def percentile_ms(xs: list) -> dict:
    return {"n": len(xs), "p50_ms": float(np.percentile(xs, 50)) * 1e3, "p99_ms": float(np.percentile(xs, 99)) * 1e3} if xs else {"n": 0}


def warm_under_traffic(M, scratch: str, clock, device: str, n_slots: int, ways: int) -> dict:
    """Step 3: UNDER_THREADS client threads drive submit_rows at the
    UNDER_BATCH bucket into a served engine while snapshot_once runs
    UNDER_SNAPSHOTS times, UNDER_GAP_S apart: the state lock's hold and the
    host drain of each export, each snapshot's time (snapshot.write_ms),
    submit_rows p50/p99 with a snapshot in flight and without, and the
    slowest submits with the snapshot and the interpreter's garbage
    collections they overlapped (gc.callbacks). Then the restore of the
    last file, timed from the file to the first served launch: load and
    CRC, reconcile, upload, launch."""
    import gc

    from api_ratelimit_tpu_torch.persist.snapshot import load_snapshot, reconcile_rows
    from api_ratelimit_tpu_torch.persist.snapshotter import SlabSnapshotter
    from api_ratelimit_tpu_torch.stats.store import Store

    def engine():
        return M.cuda_mod.SlabDeviceEngine(
            clock, n_slots=n_slots, ways=ways, buckets=BUCKETS, device=device,
            hotkey_lanes=HOTKEY_LANES, hotkey_k=HOTKEY_K, precompile=True,
        )

    snap_dir = os.path.join(scratch, "under")
    rng = np.random.default_rng(31)
    blocks = [key_block(zipf_keys(rng, UNDER_BATCH, UNDER_KEYS)) for _ in range(UNDER_THREADS)]
    eng = engine()
    store = Store()
    snap = SlabSnapshotter(eng, snap_dir, interval_ms=WARM_SNAPSHOT_MS, time_source=clock, scope=store.scope("ratelimit"))
    for block in blocks:
        eng.submit_rows(block)  # warm every thread's block once
    stop = threading.Event()
    spans: list = [[] for _ in blocks]
    errors: list = []

    def client(i):
        try:
            while not stop.is_set():
                t = time.perf_counter()
                eng.submit_rows(blocks[i])
                spans[i].append((t, time.perf_counter()))
        except Exception as e:  # noqa: BLE001 (re-raised by the check below)
            errors.append(repr(e))

    gc_open: dict = {}
    gc_pauses: list = []  # (start, end, generation)

    def on_gc(phase, info):
        if phase == "start":
            gc_open[threading.get_ident()] = time.perf_counter()
        elif threading.get_ident() in gc_open:
            gc_pauses.append((gc_open.pop(threading.get_ident()), time.perf_counter(), info["generation"]))

    pool = [threading.Thread(target=client, args=(i,)) for i in range(UNDER_THREADS)]
    gc.callbacks.append(on_gc)
    for t in pool:
        t.start()
    snapshots = []
    try:
        time.sleep(UNDER_GAP_S)
        for _ in range(UNDER_SNAPSHOTS):
            t = time.perf_counter()
            wrote = snap.snapshot_once()
            snapshots.append((t, time.perf_counter()))
            check(wrote > 0, "snapshot_once failed under traffic")
            time.sleep(UNDER_GAP_S)
    finally:
        stop.set()
        for t in pool:
            t.join()
        gc.callbacks.remove(on_gc)
    check(not errors, f"submit_rows failed under snapshots: {errors[:3]}")
    during, outside = [], []
    for s0, s1 in (s for per in spans for s in per):
        (during if any(s0 < b and a < s1 for a, b in snapshots) else outside).append(s1 - s0)

    def overlap_ms(s0, s1, windows):
        return sum(max(0.0, min(s1, b) - max(s0, a)) for a, b, *_ in windows) * 1e3

    slowest = sorted((s for per in spans for s in per), key=lambda x: x[0] - x[1])[:8]
    slowest = [
        {
            "ms": (s1 - s0) * 1e3,
            "snapshot": next((i for i, (a, b) in enumerate(snapshots) if s0 < b and a < s1), None),
            "snapshot_overlap_ms": overlap_ms(s0, s1, snapshots),
            "gc_ms": overlap_ms(s0, s1, gc_pauses),
        }
        for s0, s1 in slowest
    ]
    check(len(during) > 0 and len(outside) > 0, f"{len(during)} submits during snapshots, {len(outside)} outside")
    exports = list(eng.export_times)[-UNDER_SNAPSHOTS:]
    write_ms = [(b - a) * 1e3 for a, b in snapshots]
    hist = store.metrics_snapshot()["histograms"].get("ratelimit.snapshot.write_ms", {})

    path = os.path.join(snap_dir, "slab.snap")
    fresh = engine()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _header, table = load_snapshot(path)
    t1 = time.perf_counter()
    table, stats = reconcile_rows(table, int(clock.unix_now()))
    t2 = time.perf_counter()
    fresh.import_tables([table])
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    fresh.submit_rows(blocks[0][:, :128])
    t4 = time.perf_counter()
    check(stats["restored"] > 0, "the last snapshot holds no live row")
    again = engine()
    t5 = time.perf_counter()
    whole = SlabSnapshotter(again, snap_dir, interval_ms=WARM_SNAPSHOT_MS, time_source=clock).restore()
    t6 = time.perf_counter()
    check(whole.get("restored") == stats["restored"], f"restore() restored {whole} against {stats['restored']}")
    for e in (eng, fresh, again):
        e.close()
    return {
        "client_threads": UNDER_THREADS,
        "batch": UNDER_BATCH,
        "snapshots": len(snapshots),
        "lock_held_ms": [lock for lock, _drain in exports],
        "host_drain_ms": [drain for _lock, drain in exports],
        "write_ms": write_ms,
        "write_ms_histogram": {k: hist.get(k) for k in ("count", "p50", "p99") if k in hist},
        "submit_rows_during_snapshot": percentile_ms(during),
        "submit_rows_without_snapshot": percentile_ms(outside),
        "slowest_submits": slowest,
        "gc_pauses": {
            "count": len(gc_pauses),
            "max_ms": max(((b - a) * 1e3 for a, b, _g in gc_pauses), default=0.0),
            "gen2_count": sum(1 for *_ab, g in gc_pauses if g == 2),
            "gen2_max_ms": max(((b - a) * 1e3 for a, b, g in gc_pauses if g == 2), default=0.0),
        },
        "restore": {
            "load_crc_ms": (t1 - t0) * 1e3,
            "reconcile_ms": (t2 - t1) * 1e3,
            "upload_ms": (t3 - t2) * 1e3,
            "first_launch_ms": (t4 - t3) * 1e3,
            "file_to_first_launch_ms": (t4 - t0) * 1e3,
            "restore_call_ms": (t6 - t5) * 1e3,
            "rows": stats["restored"],
        },
    }


def warm_redis_oracle(K, runtime_root: str, clock, device: str, overrides: dict) -> dict:
    """Step 4: the port's FakeRedisServer on 127.0.0.1 (TCP, no TLS) on the
    runner's fake clock behind a BACKEND_TYPE=redis runner, and a
    BACKEND_TYPE=cuda runner, both with EXPIRATION_JITTER_MAX_SECONDS=0:
    REDIS_CALLS v3 calls answered byte for byte alike, the cuda runner
    launching each kernel once a call and the fake taking one INCRBY a
    descriptor."""
    from api_ratelimit_tpu_torch.testing.fake_redis import FakeRedisServer

    fake = FakeRedisServer(clock=clock.unix_now)
    reqs, steps = warm_stream(37, REDIS_CALLS)
    runners = []
    try:
        redis, _ = process_boot(
            process_env(
                runtime_root, backend="redis", REDIS_SOCKET_TYPE="tcp", REDIS_URL=fake.addr,
                EXPIRATION_JITTER_MAX_SECONDS=0,
            ),
            device=device,
        )
        runners.append(redis)
        card, _ = process_boot(process_env(runtime_root, EXPIRATION_JITTER_MAX_SECONDS=0, **overrides), device=device)
        runners.append(card)
        K.reset_launch_counts()
        got, want = warm_calls([card, redis], clock, reqs, steps, 0, REDIS_CALLS)
        launches = served_launches(K)
        check(got == want, "the card's responses differ from the redis backend's")
        incrby = sum(1 for c in fake.commands_seen if c[0] == b"INCRBY")
        descriptors = sum(len(r.descriptors) for r in reqs)
        check(incrby == descriptors, f"the fake took {incrby} INCRBYs for {descriptors} descriptors")
        if device == "cuda":
            check(all(v == REDIS_CALLS for v in launches.values()), f"{REDIS_CALLS} calls launched {launches}")
        codes = collections.Counter(v for raw in got for v in verdicts(raw))
        check(len(codes) >= 2, f"the redis stream did not cross a limit: {dict(codes)}")
    finally:
        for r in runners:
            r.stop()
        fake.close()
    return {"calls": REDIS_CALLS, "descriptors": descriptors, "incrby": incrby, "codes": dict(codes), "launches": launches}


def phase_warm_restart(M, K, device: str = "cuda", keep_snapshot: bool = False, **overrides) -> dict:
    """Warm restart and the redis oracle at phase 9's deployment (module
    docstring, phase 11). `overrides`: environment variables for the cuda
    runners and the standalone engine (a small slab on the CPU)."""
    import tempfile

    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    t_phase = time.perf_counter()
    steps = {}

    def lap(name: str) -> None:
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    n_slots = int(overrides.get("TPU_SLAB_SLOTS", N_SLOTS))
    ways = int(overrides.get("SLAB_WAYS", 0)) or 128
    with tempfile.TemporaryDirectory(prefix="chip_smoke_warm_") as scratch:
        runtime_root = os.path.join(scratch, "runtime")
        process_runtime(runtime_root)
        clock = FakeTimeSource(NOW0)
        install_process_time_source(clock)
        try:
            handoff = warm_handoff(K, runtime_root, scratch, clock, device, overrides, keep=keep_snapshot)
            lap("handoff")
            crash = warm_crash(K, runtime_root, scratch, clock, device, overrides)
            lap("crash")
            under = warm_under_traffic(M, scratch, clock, device, n_slots, ways)
            lap("under_traffic")
            redis = warm_redis_oracle(K, runtime_root, clock, device, overrides)
            lap("redis")
        finally:
            install_process_time_source(RealTimeSource())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
    ) if device == "cuda" else None
    out = {
        "handoff": handoff,
        "crash": crash,
        "under_traffic": under,
        "redis": redis,
        "card": smi.stdout.strip() if smi is not None else "not measured (cpu)",
        "phase_s": time.perf_counter() - t_phase,
        "step_s": steps,
    }
    log(
        f"warm restart: handoff {handoff['live_rows']} rows restored, crash false_over {crash['false_over']} "
        f"over-admits {crash['over_admits']} (lost hits {crash['lost_hits']}), lock held "
        f"{max(under['lock_held_ms']):.3f} ms max, drain {np.median(under['host_drain_ms']):.1f} ms, snapshot "
        f"{np.median(under['write_ms']):.0f} ms, submit p99 {under['submit_rows_during_snapshot']['p99_ms']:.2f}/"
        f"{under['submit_rows_without_snapshot']['p99_ms']:.2f} ms during/without, restore "
        f"{under['restore']['file_to_first_launch_ms']:.0f} ms, redis {redis['calls']} calls equal ({out['phase_s']:.1f} s)"
    )
    return out


# the tiers phase (12): bench.py bench_keyspace_overload's structure at the
# default deployment's geometry (2^22 slots, W = 128, the production sketch,
# the VICTIM_MAX_ROWS and VICTIM_WATERMARK defaults)
TIER_SETS = 1024  # the sets the stream touches, of 2^22 / 128 = 32768
TIER_WAYS = 128
TIER_POOL = 5 * TIER_WAYS  # the keys a set round-robins: 5x its ways
TIER_ROUNDS = 1600  # launches of TIER_SETS items, one key a set
TIER_LIMIT, TIER_DIVIDER = 1, 3600
TIER_MAX_ROWS, TIER_WATERMARK = 1 << 20, 0.85
TIER_PLAIN_ROUNDS = 64  # each window of the plain-kernel twin
TIER_PLAIN_FROM = (0, TIER_POOL)  # the first launches; the first second-pass launches, which promote
TIER_COST_BLOCKS = 16  # phase 3's 65536-item Zipf blocks, tier on against off
LEASE_CALLS = 2048  # the sequential v3 stream on a few hot keys
LEASE_AFTER_CALLS = 512  # the calls after the restart
LEASE_WINDOW_CALLS = 256  # the dispatch loop's run
LEASE_KEYS = (  # (descriptor, the rule's limit in the phase's one window)
    ([("user", "u1")], 20), ([("user", "u2")], 20), ([("user", "u3")], 20),
    ([("tenant", "t1"), ("path", "/p1")], 400), ([("tenant", "t2"), ("path", "/p2")], 400),
    ([("ip", "10.0.0.1")], 10),
)


def launch_counts(K) -> collections.Counter:
    """Every launch counter: LAUNCHES by kernel, and the way scan's form
    counters under way_scan/<form> and way_scan_multi/<form>."""
    out = collections.Counter(K.LAUNCHES)
    out.update({f"way_scan/{k}": v for k, v in K.WAY_SCAN_FORMS.items()})
    out.update({f"way_scan_multi/{k}": v for k, v in K.WAY_SCAN_MULTI_FORMS.items()})
    return out


def tier_block(r: int, n_sets: int) -> np.ndarray:
    """Launch r of the overload stream: one key a set over TIER_SETS sets
    spread across the slab, each set round-robining TIER_POOL keys. The set
    is fp_lo's low bits, the key's id the bits above them and fp_hi's top 16
    bits (colliding keys need distinct top bits, as in bench.py)."""
    uid = np.uint64(r % TIER_POOL)
    sets = np.arange(TIER_SETS, dtype=np.uint64) * np.uint64(n_sets // TIER_SETS)
    block = np.empty((6, TIER_SETS), np.uint32)
    block[0] = sets | (uid << np.uint64(n_sets.bit_length() - 1))
    block[1] = (int(uid) + 1) << 16
    block[2] = 1
    block[3] = TIER_LIMIT
    block[4] = TIER_DIVIDER
    block[5] = 0
    return block


def tier_engine(M, clock, device, n_slots: int, victim_max_rows: int):
    return M.cuda_mod.SlabDeviceEngine(
        clock, n_slots=n_slots, ways=TIER_WAYS, buckets=BUCKETS, device=device,
        hotkey_lanes=HOTKEY_LANES, hotkey_k=HOTKEY_K,
        victim_max_rows=victim_max_rows, victim_watermark=TIER_WATERMARK,
    )


def sorted_rows(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])]


def tier_overload(M, K, device: str, n_slots: int, rounds: int) -> dict:
    """Step (a): the overload stream through the tier-off and tier-on
    engines, in turns (which goes first alternates), each decision held
    against VictimOracle; a plain-kernel twin of the tier-on engine over
    TIER_PLAIN_ROUNDS launches from each of TIER_PLAIN_FROM, from the
    kernel engine's state there; per-arm launch counts."""
    from api_ratelimit_tpu_torch.testing.oracle import VictimOracle
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    n_sets = n_slots // TIER_WAYS
    clocks = {name: FakeTimeSource(NOW0) for name in ("off", "on", "plain")}
    arms = {"off": tier_engine(M, clocks["off"], device, n_slots, 0),
            "on": tier_engine(M, clocks["on"], device, n_slots, TIER_MAX_ROWS)}
    oracle = VictimOracle()
    stats = {name: {"false_admits": 0, "false_overs": 0, "launch_ms": []} for name in arms}
    launches = {name: collections.Counter() for name in arms}
    promote_rounds = oracle_overs = 0
    plain, plain_checks = None, []
    K.reset_launch_counts()
    for r in range(rounds):
        block = tier_block(r, n_sets)
        items = [(lo, hi, 1, TIER_LIMIT, TIER_DIVIDER, 0) for lo, hi in zip(block[0].tolist(), block[1].tolist())]
        over = np.asarray(oracle.step_batch(items, NOW0)) == 2
        oracle_overs += int(over.sum())
        promotes_before = arms["on"].victim_tier.promotes_total
        got = {}
        for name in (("off", "on") if r % 2 == 0 else ("on", "off")):
            before = launch_counts(K)
            t0 = time.perf_counter()
            got[name] = arms[name].submit_rows(block).copy()
            stats[name]["launch_ms"].append((time.perf_counter() - t0) * 1e3)
            launches[name] += launch_counts(K) - before
            admitted = got[name] <= TIER_LIMIT
            stats[name]["false_admits"] += int((over & admitted).sum())
            stats[name]["false_overs"] += int((~over & ~admitted).sum())
        promote_rounds += arms["on"].victim_tier.promotes_total > promotes_before
        if r in TIER_PLAIN_FROM:
            # the twin starts from the kernel engine's state before launch r
            plain = tier_engine(M, clocks["plain"], device, n_slots, TIER_MAX_ROWS)
            plain_start = r
            if r:
                plain.import_tables(plain_tables)
                plain.victim_tier.import_rows(plain_tier, NOW0)
        if plain is not None:
            with plain_kernels(M):
                want = plain.submit_rows(block).copy()
            check(np.array_equal(got["on"], want), f"the plain-kernel twin's afters differ at launch {r}")
            if r == plain_start + TIER_PLAIN_ROUNDS - 1:
                check(np.array_equal(arms["on"].export_tables()[0], plain.export_tables()[0]), f"the plain twin's table differs after launch {r}")
                check(np.array_equal(sorted_rows(arms["on"].victim_tier.export_rows()), sorted_rows(plain.victim_tier.export_rows())),
                      f"the plain twin's tier differs after launch {r}")
                plain_checks.append({"from": plain_start, "launches": TIER_PLAIN_ROUNDS,
                                     "tier_rows": plain.victim_tier.rows, "promotes": plain.victim_tier.promotes_total})
                plain.close()
                plain = None
        if r + 1 in TIER_PLAIN_FROM:
            plain_tables = arms["on"].export_tables()
            plain_tier = arms["on"].victim_tier.export_rows()
    on, off = arms["on"], arms["off"]
    tier = on.victim_tier
    h_on, h_off = on.health_snapshot(), off.health_snapshot()
    bound = h_on["drops"] + tier.overflow_lost_count_sum
    check(stats["on"]["false_admits"] <= bound and bound == 0, f"tier on: {stats['on']['false_admits']} false admits, bound {bound}")
    check(stats["off"]["false_admits"] > 0, "the tier-off control admitted nothing the oracle refused: the stream lost its teeth")
    check(stats["on"]["false_overs"] == stats["off"]["false_overs"] == 0, f"false overs: {stats['on']['false_overs']} on, {stats['off']['false_overs']} off")
    want_rows = TIER_SETS * (TIER_POOL - TIER_WAYS) if rounds >= TIER_POOL else None
    if want_rows is not None:
        check(tier.rows == want_rows, f"the tier holds {tier.rows} rows, expected {want_rows}")
    check(tier.rows < TIER_MAX_ROWS * TIER_WATERMARK and tier.watermark_reason() is None, "the tier passed its watermark")
    check(promote_rounds > 0 or rounds <= TIER_POOL, "no launch promoted")
    if device == "cuda":  # the plain versions on the CPU count no launch
        multi = sum(launches["on"][f"way_scan_multi/{f}"] for f in ("set_major", "per_item"))
        check(multi == promote_rounds, f"{promote_rounds} promote passes ran {multi} multi-algorithm way scans")
        check(launches["on"]["way_scan"] == rounds + multi, f"tier-on way scans: {launches['on']['way_scan']} for {rounds} launches + {multi} promotes")
        for name in arms:
            for kernel in ("slab_apply", "sketch_update"):
                check(launches[name][kernel] == rounds, f"{name}: {kernel} launched {launches[name][kernel]} times in {rounds} launches")
        check(launches["off"]["way_scan"] == rounds and not any(launches["off"][f"way_scan_multi/{f}"] for f in ("set_major", "per_item")),
              f"tier-off launches: {dict(launches['off'])}")
    events = tier.demotes_total + tier.promotes_total + tier.overflow_drops_total
    on_s, off_s = sum(stats["on"]["launch_ms"]) / 1e3, sum(stats["off"]["launch_ms"]) / 1e3
    out = {
        "n_slots": n_slots, "ways": TIER_WAYS, "sets": TIER_SETS, "pool": TIER_POOL,
        "keyspace": TIER_SETS * TIER_POOL, "multiplier": TIER_POOL // TIER_WAYS, "launches": rounds,
        "items_per_launch": TIER_SETS, "decisions": rounds * TIER_SETS, "oracle_overs": oracle_overs,
        "victim_max_rows": TIER_MAX_ROWS,
        "on": {
            "false_admits": stats["on"]["false_admits"], "false_overs": stats["on"]["false_overs"],
            "drops": h_on["drops"], "overflow_lost_count_sum": tier.overflow_lost_count_sum,
            "evictions_live": h_on["evictions_live"], "demotes": tier.demotes_total,
            "promotes": tier.promotes_total, "tier_rows": tier.rows, "overflow_drops": tier.overflow_drops_total,
            "promote_passes": promote_rounds, "launch_s": on_s,
            "launch_ms_median": float(np.median(stats["on"]["launch_ms"])),
            "drain_ms_median": [float(np.median([w for w, _a in on.victim_drain_times])),
                                float(np.median([a for _w, a in on.victim_drain_times]))],
        },
        "off": {
            "false_admits": stats["off"]["false_admits"], "false_overs": stats["off"]["false_overs"],
            "evictions_live": h_off["evictions_live"], "loss_ppm": h_off["loss_ppm"], "launch_s": off_s,
            "launch_ms_median": float(np.median(stats["off"]["launch_ms"])),
        },
        "tier_event_us": (on_s - off_s) / events * 1e6 if events else None,
        "launch_counts": {name: dict(c) for name, c in launches.items()},
        "plain_twin": plain_checks,
    }
    return out, arms


def tier_promote_row(M, dev, eng, n_slots: int, err: dict) -> dict:
    """The kernels line's row of the way scan's multi-algorithm
    instantiation at a promote's shape: the fingerprints the tier-on
    engine's next launch promotes, padded to their bucket as the engine
    pads them, over its table; kernel against the plain version."""
    K = M.K
    block = tier_block(TIER_ROUNDS, n_slots // TIER_WAYS)
    rows = eng.victim_tier.lookup_batch(block[0], block[1])
    check(rows is not None, "the next launch would promote nothing")
    k = rows.shape[0]
    padded = np.zeros((eng._bucket_for(k), 8), np.uint32)
    padded[:k] = rows
    lo, hi = i32(padded[:, 0], dev), i32(padded[:, 1], dev)
    table = eng._state.table
    args = (table, lo, hi, NOW0, TIER_WAYS)
    err["way_scan_multi_promote"] = max_abs_err(K.way_scan(*args, multi_algo=True), K.way_scan_plain(*args, multi_algo=True))
    check(err["way_scan_multi_promote"] == 0, "the promote's multi-algorithm way scan differs from its plain version")
    b = lo.shape[0]
    sets = int(torch.unique(lo & (table.shape[0] // TIER_WAYS - 1)).numel())
    return {
        "name": "way_scan_multi",
        "route": "cuda",
        "source": SOURCES["way_scan_multi"],
        "replaces": REPLACES["way_scan_multi"],
        "shape": f"b={b}, W={TIER_WAYS}, {table.shape[0]}-slot table, a victim-tier promote ({k} rows)",
        "max_abs_err": err["way_scan_multi_promote"],
        "ms": device_ms(lambda: K.way_scan(*args, multi_algo=True)),
        "plain_ms": device_ms(lambda: K.way_scan_plain(*args, multi_algo=True), iters=5),
        "bound_ms": (sets * TIER_WAYS * 32 + b * (8 + 4 + 1 + 32)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "call_ms": call_ms(lambda: K.way_scan(*args, multi_algo=True)),
        "plain_call_ms": call_ms(lambda: K.way_scan_plain(*args, multi_algo=True), iters=5),
        "form": K.way_scan_form(b, table.shape[0] // TIER_WAYS, TIER_WAYS),
        "path": "victim_tier",
    }


def tier_cost(M, K, device: str, n_slots: int, profiled: bool = True) -> dict:
    """Step (b): phase 3's Zipf(1.1) stream (2^20 keys) at the 65536
    bucket into a tier-on and a tier-off engine, each block to both in A B
    B A order: submit_rows medians, the demote drain's host ms, and (on the
    card) the device activities of a submit in each arm with the ones the
    tier adds, by name. Printed, not claimed."""
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    rng = np.random.default_rng(2)
    arms = {"on": tier_engine(M, FakeTimeSource(NOW0), device, n_slots, TIER_MAX_ROWS),
            "off": tier_engine(M, FakeTimeSource(NOW0), device, n_slots, 0)}
    blocks = [key_block(zipf_keys(rng, BUCKETS[-1])) for _ in range(TIER_COST_BLOCKS)]
    ms = {name: [] for name in arms}
    for i, block in enumerate(blocks):
        for name in (("on", "off") if i % 2 == 0 else ("off", "on")):
            t0 = time.perf_counter()
            got = arms[name].submit_rows(block)
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "on":
                want_on = got.copy()
            else:
                want_off = got.copy()
        check(np.array_equal(want_on, want_off) or arms["on"].victim_tier.demotes_total, f"block {i}: the tier changed afters without a demote")
    drains = list(arms["on"].victim_drain_times)[-TIER_COST_BLOCKS:]
    out = {
        "blocks": TIER_COST_BLOCKS, "batch": BUCKETS[-1],
        "submit_rows_ms_median": {name: float(np.median(v)) for name, v in ms.items()},
        "drain_wait_ms_median": float(np.median([w for w, _a in drains])),
        "drain_absorb_ms_median": float(np.median([a for _w, a in drains])),
        "demotes": arms["on"].victim_tier.demotes_total,
    }
    if profiled:
        block = blocks[0]
        (on, on_us), (off, off_us) = (traced_calls(lambda e=arms[n]: e.submit_rows(block), 5) for n in ("on", "off"))
        extra = collections.Counter(on) - collections.Counter(off)
        out["activities"] = {
            "on": sum(on.values()), "off": sum(off.values()),
            "device_ms_on": summed_ms(on, on_us), "device_ms_off": summed_ms(off, off_us),
            "added": sorted((name[:60], n) for name, n in extra.items()),
            "removed": sorted((name[:60], n) for name, n in (collections.Counter(off) - collections.Counter(on)).items()),
        }
    for eng in arms.values():
        eng.close()
    return out


def tier_snapshot(M, device: str, n_slots: int, eng) -> dict:
    """Step (c): snapshot_once of the tier-on engine after (a), then
    restore() into a fresh tier-on engine: its tier holds exactly the
    exported rows after reconcile_rows, and its slab the exported table."""
    import tempfile

    from api_ratelimit_tpu_torch.persist.snapshot import reconcile_rows
    from api_ratelimit_tpu_torch.persist.snapshotter import SlabSnapshotter
    from api_ratelimit_tpu_torch.utils import FakeTimeSource

    clock = FakeTimeSource(NOW0 + 30)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiers_") as snap_dir:
        t0 = time.perf_counter()
        wrote = SlabSnapshotter(eng, snap_dir, interval_ms=WARM_SNAPSHOT_MS, time_source=clock).snapshot_once()
        t1 = time.perf_counter()
        check(wrote > 0 and os.path.exists(os.path.join(snap_dir, "victim.snap")), "snapshot_once wrote no victim.snap")
        victim_bytes = os.path.getsize(os.path.join(snap_dir, "victim.snap"))
        fresh = tier_engine(M, clock, device, n_slots, TIER_MAX_ROWS)
        t2 = time.perf_counter()
        stats = SlabSnapshotter(fresh, snap_dir, interval_ms=WARM_SNAPSHOT_MS, time_source=clock).restore()
        t3 = time.perf_counter()
    want, rec = reconcile_rows(eng.victim_tier.export_rows(), int(clock.unix_now()))
    want = want[want.any(axis=1)]
    got = fresh.victim_tier.export_rows()
    check(np.array_equal(sorted_rows(got), sorted_rows(want)), "the restored tier differs from the exported rows after reconcile_rows")
    check(stats["restored_victim_rows"] == want.shape[0] > 0, f"restore_stats {stats}")
    check(np.array_equal(fresh.export_tables()[0], reconcile_rows(eng.export_tables()[0], int(clock.unix_now()))[0]), "the restored slab differs")
    fresh.close()
    return {
        "victim_snap_bytes": victim_bytes, "rows": int(want.shape[0]), "reconcile": rec,
        "snapshot_once_ms": (t1 - t0) * 1e3, "restore_ms": (t3 - t2) * 1e3,
        "restored_victim_rows": stats["restored_victim_rows"], "dropped_victim_rows": stats["dropped_victim_rows"],
    }


def lease_requests(rng, n: int, salt: str = "") -> list:
    """n single-descriptor v3 requests of one hit over LEASE_KEYS (a
    hot-skewed choice), `salt` appended to every value."""
    from api_ratelimit_tpu_torch.pb import rls_v3

    picks = rng.choice(len(LEASE_KEYS), n, p=np.array([8, 4, 2, 6, 3, 1]) / 24)
    out = []
    for i in picks.tolist():
        req = rls_v3.RateLimitRequest(domain="proc")
        entry = req.descriptors.add()
        for k, v in LEASE_KEYS[i][0]:
            entry.entries.add(key=k, value=v + salt)
        out.append(req)
    return out


def lease_run(K, runner, reqs: list) -> tuple[list, collections.Counter]:
    """The requests through runner in order, with the launches they ran."""
    K.reset_launch_counts()
    got = warm_calls([runner], None, reqs, [0] * len(reqs), 0, len(reqs))[0]
    return got, launch_counts(K)


def admitted_per_key(reqs: list, raws: list) -> collections.Counter:
    out = collections.Counter()
    for req, raw in zip(reqs, raws):
        if verdicts(raw) == [1]:
            out[descriptor_keys(req)[0]] += 1
    return out


def tier_leases(K, device: str, overrides: dict) -> dict:
    """Step (d): two Runners at phase 9's deployment, LEASE_ENABLED true
    and false, on one fake clock that does not move: the same sequential
    stream of single-hit v3 calls on LEASE_KEYS, limits crossed, answered
    byte for byte alike, the lease arm with local answers, fewer launches
    and outstanding liabilities. The lease arm stops (its drain snapshot
    writes leases.snap); a Runner booted from the files restores the
    liabilities, and per key the restart admits no more than the limit in
    the window. Last, LEASE_ENABLED with TPU_BATCH_WINDOW=200us (the
    dispatch loop) against the lease-off Runner on fresh keys."""
    import tempfile

    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    rng = np.random.default_rng(41)
    reqs = lease_requests(rng, LEASE_CALLS)
    after_reqs = lease_requests(rng, LEASE_AFTER_CALLS)
    window_reqs = lease_requests(rng, LEASE_WINDOW_CALLS, salt="w")
    limits = {tuple(tuple(p) for p in d): lim for d, lim in LEASE_KEYS}
    runners = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_leases_") as scratch:
        root, snap_dir = os.path.join(scratch, "runtime"), os.path.join(scratch, "snap")
        process_runtime(root)
        clock = FakeTimeSource(NOW0)
        install_process_time_source(clock)
        try:
            off, _ = process_boot(process_env(root, LEASE_ENABLED="false", **overrides), device=device)
            runners.append(off)
            on, _ = process_boot(warm_env(root, snap_dir, LEASE_ENABLED="true", **overrides), device=device)
            runners.append(on)
            check(on.lease_table is not None and off.lease_table is None, "LEASE_ENABLED did not build the lease table")
            got_off, launches_off = lease_run(K, off, reqs)
            got_on, launches_on = lease_run(K, on, reqs)
            check(got_on == got_off, "the lease arm's answers differ from the lease-off arm's")
            codes = collections.Counter(v for raw in got_on for v in verdicts(raw))
            check(codes[1] > 0 and codes[2] > 0, f"the lease stream did not cross a limit: {dict(codes)}")
            counters = on.stats_store.debug_snapshot()
            local_hits = counters.get("ratelimit.lease.local_hits", 0)
            entries, tokens = on.cache.engine.lease_registry.outstanding()
            check(local_hits > 0, f"no call was answered from a lease: {counters}")
            if device == "cuda":
                check(launches_on["slab_apply"] < launches_off["slab_apply"] == len(reqs),
                      f"launches: {launches_on['slab_apply']} with leases, {launches_off['slab_apply']} without")
            check(entries > 0 and tokens > 0, "no lease liability is outstanding")
            before = admitted_per_key(reqs, got_on)
            on.stop()
            runners.remove(on)
            back, _ = process_boot(warm_env(root, snap_dir, LEASE_ENABLED="true", **overrides), device=device)
            runners.append(back)
            restored = back.snapshotter.restore_stats
            check(restored.get("restored_leases", 0) > 0, f"leases.snap restored nothing: {restored}")
            got_after, _ = lease_run(K, back, after_reqs)
            after = admitted_per_key(after_reqs, got_after)
            totals = {str(k): (before[k], after[k], limits[k]) for k in limits}
            over = {k: v for k, v in totals.items() if v[0] + v[1] > v[2]}
            check(not over, f"the restart admitted past a limit: {over}")
            win, _ = process_boot(process_env(root, LEASE_ENABLED="true", TPU_BATCH_WINDOW="200us", **overrides), device=device)
            runners.append(win)
            check(win.cache.engine.dispatch_loop is not None, "TPU_BATCH_WINDOW=200us did not start the dispatch loop")
            got_win, _ = lease_run(K, win, window_reqs)
            want_win, _ = lease_run(K, off, window_reqs)
            check(got_win == want_win, "the dispatch loop's lease answers differ from the lease-off runner's")
            win_local = win.stats_store.debug_snapshot().get("ratelimit.lease.local_hits", 0)
            check(win_local > 0 and win.cache.engine.lease_registry.outstanding()[0] > 0, "the dispatch loop's leases did not answer locally")
        finally:
            for r in runners:
                r.stop()
            install_process_time_source(RealTimeSource())
    return {
        "calls": len(reqs), "codes": dict(codes), "local_hits": local_hits,
        "slab_apply_launches": {"lease_on": launches_on["slab_apply"], "lease_off": launches_off["slab_apply"]},
        "outstanding": [entries, tokens],
        "restore_stats": {k: restored.get(k) for k in ("restored", "restored_leases", "dropped_leases")},
        "admitted_before_after_limit": totals,
        "dispatch_loop": {"calls": len(window_reqs), "local_hits": win_local},
    }


def phase_tiers(M, K, device: str = "cuda", n_slots: int = N_SLOTS, rounds: int = TIER_ROUNDS, profiled: bool = True, **overrides) -> dict:
    """The victim tier and leases at the default deployment (module
    docstring, phase 12). `overrides`: environment variables for the
    runners of step (d) (a small slab on the CPU)."""
    t_phase = time.perf_counter()
    steps = {}

    def lap(name: str) -> None:
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    dev = torch.device(device)
    overload, arms = tier_overload(M, K, device, n_slots, rounds)
    lap("overload")
    err: dict = {}
    row = tier_promote_row(M, dev, arms["on"], n_slots, err) if device == "cuda" else None
    if row is not None:
        row["launches"] = overload["on"]["promote_passes"]
    lap("promote_row")
    snap = tier_snapshot(M, device, n_slots, arms["on"])
    lap("snapshot")
    for eng in arms.values():
        eng.close()
    del arms
    cost = tier_cost(M, K, device, n_slots, profiled=profiled)
    lap("cost")
    leases = tier_leases(K, device, overrides)
    lap("leases")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
    ) if device == "cuda" else None
    out = {
        "overload": overload, "snapshot": snap, "cost": cost, "leases": leases,
        "card": smi.stdout.strip() if smi is not None else "not measured (cpu)",
        "phase_s": time.perf_counter() - t_phase, "step_s": steps,
    }
    on, off = overload["on"], overload["off"]
    log(
        f"tiers: {overload['keyspace']} keys ({overload['multiplier']}x the touched sets' ways), false admits "
        f"{on['false_admits']} on / {off['false_admits']} off, {on['demotes']} demotes, {on['promotes']} promotes, "
        f"{on['tier_rows']} tier rows, launch {on['launch_ms_median']:.3f}/{off['launch_ms_median']:.3f} ms on/off, "
        f"leases {leases['local_hits']} local hits ({out['phase_s']:.1f} s)"
    )
    return out, row


FLEET_WORKERS = 4  # FRONTEND_PROCS of arms (a) and (b)
FLEET_CLIENT_PROCS = 8
FLEET_CLIENT_THREADS = 16
# the phase's run times, cut to keep the script within its time (three
# processes boot on the card: arm (a)'s owner, (c)'s single-process Runner,
# and the external owner that (b) and (c)'s one-worker run share); the
# deployment's width is not cut
FLEET_ARM_S = 6.0  # each arm's measured load
# the same load on after the measured seconds, for the owner's trace: a
# warmed capture took 2.6 s from its request to its end in arm (a)
FLEET_TAIL_S = 5.0
FLEET_KILL_S = 3.0  # arm (a)'s second wave, a worker SIGKILLed in it
FLEET_C_S = 4.0  # each of (c)'s single-process and one-worker runs
FLEET_SHARED_KEYS = 16
# fixed window, per hour: low enough that every shared key crosses it in an
# arm at the fleet's rate on the card (the socket arm's ~700 calls/s, 1 in
# 256 of them on a key)
FLEET_SHARED_LIMIT = 8
FLEET_CONC_KEYS = 16
FLEET_CONC_CAP = 4  # concurrency, acquire only
FLEET_SHARED_EVERY = 8  # one call in eight carries a shared key
FLEET_PROFILE_MS = 500
FLEET_LEASE_CALLS = 1024
FLEET_BOOT_S = 300.0
FLEET_RULES = PROCESS_RULES + f"""\
  - key: shared
    rate_limit: {{unit: hour, requests_per_unit: {FLEET_SHARED_LIMIT}}}
"""
FLEET_CONC_RULE = f"""\
  - key: conc
    rate_limit: {{requests_per_unit: {FLEET_CONC_CAP}, algorithm: concurrency}}
"""
SERVICE_CMD = "api_ratelimit_tpu_torch.cmd.service_cmd"
SIDECAR_CMD = "api_ratelimit_tpu_torch.cmd.sidecar_cmd"


def port_run(n: int, avoid=()) -> int:
    """The first of n consecutive free ports (the fleet's debug layout),
    none of them in `avoid`: ports picked a moment before and released
    until their servers bind them. The listeners bind with SO_REUSEPORT,
    so a debug port equal to the fleet's gRPC port would be shared
    silently and answer HTTP/2 to a /metrics read."""
    import socket

    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(20000, 60000 - n))
        if any(base <= p < base + n for p in avoid):
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no run of {n} free ports")


def fleet_runtime(root: str, conc: bool = False) -> None:
    config = os.path.join(root, "ratelimit", "config")
    os.makedirs(config, exist_ok=True)
    write_text(os.path.join(config, "proc.yaml"), FLEET_RULES + (FLEET_CONC_RULE if conc else ""))


def fleet_env(root: str, scratch: str, tag: str, backend: str = "cuda", **overrides) -> dict:
    """The default deployment (process_env) with the dispatch loop
    (TPU_BATCH_WINDOW=200us), the owner's socket, profile and snapshot
    directories under scratch, and its own ports; `overrides` replace any;
    the whole of os.environ beneath it."""
    http, grpc_port = free_ports(2)
    debug = port_run(FLEET_WORKERS + 2, avoid=(http, grpc_port))
    prof = os.path.join(scratch, tag + "_profile")
    os.makedirs(prof, exist_ok=True)
    env = dict(os.environ)
    env.update(process_env(root, backend, **{
        "TPU_BATCH_WINDOW": "200us",
        "TPU_PROFILE_DIR": prof,
        "SIDECAR_SOCKET": os.path.join(scratch, tag + ".sock"),
        "SLAB_SNAPSHOT_DIR": os.path.join(scratch, tag + "_snap"),
        "SLAB_SNAPSHOT_INTERVAL_MS": str(WARM_SNAPSHOT_MS),
        "PORT": str(http), "GRPC_PORT": str(grpc_port), "DEBUG_PORT": str(debug),
        "PYTHONPATH": REPO_ROOT,
        **overrides,
    }))
    return env


def fleet_spawn(module: str, env: dict, log_path: str, argv: tuple = (), **extra) -> subprocess.Popen:
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=REPO_ROOT, env={**env, **extra},
        stdout=log_file, stderr=subprocess.STDOUT,
    )
    proc.log_path = log_path
    log_file.close()
    return proc


def log_tail(proc, n: int = 3000) -> str:
    try:
        with open(proc.log_path) as f:
            return f.read()[-n:]
    except (OSError, AttributeError):
        return ""


def children(pid: int) -> dict:
    """pid -> command line of every live child of pid (/proc)."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != pid:
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                out[int(d)] = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue
    return out


def holds_card(pid: int) -> bool:
    """True when the process has a /dev/nvidia* file open (a CUDA context
    opens the control and device nodes)."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def tcp_conns(pid: int, port: int) -> tuple[int, int]:
    """(connections the process holds on local `port`, connections on that
    port no process has accepted yet): every state but LISTEN, from its
    fd table and /proc/net/tcp{,6}. A connection still in the accept queue
    may be any of the port's listeners'."""
    inodes = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                link = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if link.startswith("socket:["):
                inodes.add(link[8:-1])
    except OSError:
        return 0, 0
    held = queued = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if int(cols[1].rsplit(":", 1)[1], 16) != port or cols[3] == "0A":
                continue
            if cols[9] in inodes:
                held += 1
            elif cols[9] == "0":
                queued += 1
    return held, queued


def wait_for(pred, what: str, timeout: float, proc=None) -> None:
    deadline = time.perf_counter() + timeout
    while True:
        try:
            if pred():
                return
        except (OSError, ConnectionError, http.client.HTTPException):
            pass
        if proc is not None:
            check(proc.poll() is None, f"{what}: the process exited with {proc.returncode}:\n{log_tail(proc)}")
        check(time.perf_counter() < deadline, f"timed out waiting for {what}")
        time.sleep(0.1)


def http_ok(port: int, path: str = "/") -> bool:
    return http_call(port, "GET", path)[0] == 200


def metrics_of(port: int, path: str = "/metrics") -> dict:
    """A /metrics exposition as {sample: value}."""
    from api_ratelimit_tpu_torch.stats.prometheus import parse_exposition

    status, body = http_call(port, "GET", path)
    check(status == 200, f"GET {path} on {port} answered {status}")
    _types, families = parse_exposition(body.decode())
    return {k: v for samples in families.values() for k, v in samples.items()}


def fleet_up(env: dict, scratch: str, tag: str, workers: int, owner: bool):
    """The master (service_cmd, FRONTEND_PROCS=workers) booted until the
    owner's /healthcheck and every worker's debug port answer. Returns
    (master, {"owner": pid or None, "workers": [pids]}, seconds)."""
    t0 = time.perf_counter()
    master = fleet_spawn(SERVICE_CMD, env, os.path.join(scratch, tag + "_master.log"), FRONTEND_PROCS=str(workers))
    debug = int(env["DEBUG_PORT"])
    if owner:
        wait_for(lambda: http_ok(debug + 1 + workers, "/healthcheck"), f"{tag}: the owner", FLEET_BOOT_S, master)
    for i in range(workers):
        wait_for(lambda i=i: http_ok(debug + 1 + i), f"{tag}: worker {i}", FLEET_BOOT_S, master)
    wait_for(lambda: http_ok(debug, "/"), f"{tag}: the aggregator", 30, master)
    pids = fleet_pids(master)
    check(len(pids["workers"]) == workers and (pids["owner"] is not None) == owner, f"{tag}: fleet processes {pids}")
    return master, pids, time.perf_counter() - t0


def fleet_pids(master) -> dict:
    kids = children(master.pid)
    return {
        "owner": next((p for p, c in kids.items() if SIDECAR_CMD in c), None),
        "workers": sorted(p for p, c in kids.items() if SERVICE_CMD in c),
    }


def fleet_down(master, what: str, timeout: float = 90.0) -> int:
    """SIGTERM to the master, which takes its workers and owner down; a
    master that hangs is killed with every child it left."""
    master.send_signal(signal.SIGTERM)
    try:
        rc = master.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for pid in children(master.pid):
            os.kill(pid, signal.SIGKILL)
        master.kill()
        master.wait()
        check(False, f"{what}: the master did not exit within {timeout} s of SIGTERM:\n{log_tail(master)}")
    return rc


def fleet_clients(port: int, seconds: float, scratch: str, tag: str, seed: int, **flags) -> list:
    """FLEET_CLIENT_PROCS load processes (tools/fleet_client.py), each of
    FLEET_CLIENT_THREADS threads, started together a few seconds from now
    (streams built, channels not yet open). Returns the handles."""
    start_at = time.time() + 3.0
    procs = []
    for i in range(FLEET_CLIENT_PROCS):
        out = os.path.join(scratch, f"{tag}_client{i}.json")
        args = ["--port", str(port), "--seconds", str(seconds), "--threads", str(FLEET_CLIENT_THREADS),
                "--seed", str(seed * 100 + i), "--start-at", repr(start_at), "--out", out,
                "--shared-every", str(FLEET_SHARED_EVERY), "--shared-keys", str(FLEET_SHARED_KEYS)]
        for k, v in flags.items():
            args += ["--" + k.replace("_", "-"), str(v)]
        env = {**os.environ, "PYTHONPATH": REPO_ROOT, "CUDA_VISIBLE_DEVICES": ""}
        log_file = open(os.path.join(scratch, f"{tag}_client{i}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "api_ratelimit_tpu_torch.tools.fleet_client", *args],
            cwd=REPO_ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        )
        log_file.close()
        proc.out, proc.log_path, proc.start_at = out, log_file.name, start_at
        procs.append(proc)
    return procs


def fleet_collect(procs: list, seconds: float, measure_s: float | None = None) -> dict:
    """Wait for the load processes and merge their results: calls, hits,
    failures (each with its load process) and shared keys over the whole
    run; requests/s and p50/p99 per
    call over the calls started in its first measure_s seconds (all when
    None), so a trace taken after them stays out of the figures."""
    merged = {"calls": 0, "descriptors": 0, "hits": 0, "failures": [], "shared": collections.Counter(), "over": collections.Counter(),
              "answered": [], "shared_calls": []}
    lat, wall = [], 0.0
    start = procs[0].start_at
    for i, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=seconds + 120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        check(rc == 0, f"a load process exited {rc}:\n{log_tail(proc)}")
        with open(proc.out) as f:
            doc = json.load(f)
        for k in ("calls", "descriptors", "hits"):
            merged[k] += doc[k]
        # each failure as the client wrote it, the load process appended:
        # (process, thread) names the failing call's connection
        merged["failures"] += [[*f, i] for f in doc["failures"]]
        merged["answered"] += doc["lat_ms"]
        merged["shared_calls"] += doc.get("shared_calls", [])
        for key, (ok, over) in doc["shared"].items():
            merged["shared"][key] += ok
            merged["over"][key] += over
        lat += [ms for t, ms in doc["lat_ms"] if measure_s is None or t < start + measure_s]
        wall = max(wall, doc["seconds"])
    window = wall if measure_s is None else measure_s
    merged["measured_calls"] = len(lat)
    merged["requests_per_s"] = len(lat) / window if window else 0.0
    merged["p50_ms"] = float(np.percentile(lat, 50)) if lat else None
    merged["p99_ms"] = float(np.percentile(lat, 99)) if lat else None
    merged["seconds"] = wall
    return merged


def trace_busy(profile_dir: str, window_ms: float) -> tuple[float, dict]:
    """The device's busy share of a /debug/profile capture (the union of
    its kernel and copy intervals over the capture) and each kernel name's
    count, from the Chrome trace(s) in profile_dir."""
    spans, names = [], collections.Counter()
    for name in sorted(os.listdir(profile_dir)):
        with open(os.path.join(profile_dir, name)) as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", []):
            cat = str(ev.get("cat", "")).lower()
            if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))))
                if cat == "kernel":
                    names[ev.get("name", "")] += 1
    busy, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / (window_ms * 1e3), dict(names)


def owner_profile(debug_port: int, profile_dir: str, ms: float = FLEET_PROFILE_MS, load_end: float = 0.0) -> dict:
    """One GET /debug/profile?ms=N on a debug port, into an empty
    profile_dir: the busy share and the kernels named. A process's first
    capture pays the tracer's start-up (seconds on the card, the process
    stalled meanwhile): warm it with a short capture before the load.
    load_end: the unix time the load stops; the capture must end before."""
    for name in os.listdir(profile_dir):
        os.remove(os.path.join(profile_dir, name))
    status, body = http_call(debug_port, "GET", f"/debug/profile?ms={ms}")
    check(not load_end or time.time() < load_end, f"the {ms} ms capture ended {time.time() - load_end:.1f} s after the load")
    check(status == 200, f"/debug/profile answered {status}: {body[:200]}")
    busy, names = trace_busy(profile_dir, ms)
    return {"busy_share": busy, "kernels": names}


# C10: several /debug/profile captures in a row, every one of them naming
# the served kernels (an empty trace came once in four runs of one). A
# 500 ms capture of the loaded owner holds ~10^4 kernels and takes ~2 s to
# write out, so the repeated ones are 200 ms, each given 1.2 s of the load
FLEET_CAPTURES = 5
FLEET_CAPTURE_MS = 200
FLEET_CAPTURE_BUDGET_S = 1.2
FLEET_SERVED_KERNELS = ("way_scan_kernel<false>", "slab_apply_kernel", "sketch_update_kernel")


def owner_profiles(debug_port: int, profile_dir: str, label: str, kernels, load_end: float,
                   n: int = FLEET_CAPTURES, ms: float = FLEET_CAPTURE_MS) -> list:
    """n owner_profile captures in a row within the load: each capture's
    kernel count printed, and every capture must name each of `kernels`
    (an empty one fails the phase; nothing is retried)."""
    out = []
    for i in range(n):
        prof = owner_profile(debug_port, profile_dir, ms=ms, load_end=load_end)
        prof["served"] = {k: named(prof["kernels"], k) for k in kernels}
        log(f"{label} capture {i + 1}/{n}: {sum(prof['kernels'].values())} kernels, served {prof['served']},"
            f" busy {prof['busy_share']:.4f}")
        out.append(prof)
    for i, prof in enumerate(out):
        check(all(prof["served"].values()), f"{label} capture {i + 1}/{n} names no served kernel: {prof['served']}")
    return out


def named(names: dict, fragment: str) -> int:
    return sum(n for k, n in names.items() if fragment in k)


def batch_mean(before: dict, after: dict, prefix: str = "ratelimit_dispatch_batch_size") -> float:
    items = after.get(prefix + "_sum", 0) - before.get(prefix + "_sum", 0)
    launches = after.get(prefix + "_count", 0) - before.get(prefix + "_count", 0)
    return items / launches if launches else 0.0


def owner_launches(before: dict, after: dict) -> dict:
    pre = "ratelimit_owner_launches_"
    return {k[len(pre):]: int(after[k] - before.get(k, 0)) for k in after if k.startswith(pre)}


def shared_exact(load: dict, prefix: str, limit: int, keys: int) -> dict:
    """Each shared key of `prefix` admitted exactly min(limit, calls), and
    every one got more calls than its limit."""
    got = {}
    for j in range(keys):
        key = f"{prefix}{j}"
        ok, over = load["shared"][key], load["over"][key]
        got[key] = [ok, over]
        check(ok + over > limit, f"shared key {key} got {ok + over} calls, not more than its limit {limit}")
        check(ok == min(limit, ok + over), f"shared key {key} admitted {ok} of {ok + over} calls, limit {limit}")
    return got


def wait_hour_margin(seconds: float) -> float:
    """The shared rule counts per clock hour: wait out an hour boundary
    that would fall inside the next `seconds`. Returns the wait."""
    left = 3600 - time.time() % 3600
    if left > seconds:
        return 0.0
    time.sleep(left + 1.0)
    return left + 1.0


def fleet_arm_a(root: str, scratch: str) -> dict:
    """Arm (a): FRONTEND_PROCS=4, BACKEND_TYPE=cuda, SHM_RINGS=true, fixed
    rules. The load's exactness, the rings, the processes on the card, the
    owner's kernels in its trace, the fleet's /metrics, a SIGKILLed worker,
    the teardown and the drain snapshot's restore."""
    fleet_runtime(root)
    env = fleet_env(root, scratch, "a", SHM_RINGS="true")
    waited = wait_hour_margin(FLEET_ARM_S + FLEET_KILL_S + 120)
    master, pids, boot_s = fleet_up(env, scratch, "a", FLEET_WORKERS, owner=True)
    debug, grpc_port = int(env["DEBUG_PORT"]), int(env["GRPC_PORT"])
    owner_debug = debug + 1 + FLEET_WORKERS
    out = {"boot_s": boot_s, "hour_wait_s": waited}
    try:
        owner_profile(owner_debug, env["TPU_PROFILE_DIR"], ms=10)
        before = metrics_of(owner_debug)
        tail = FLEET_TAIL_S + FLEET_CAPTURES * FLEET_CAPTURE_BUDGET_S
        procs = fleet_clients(grpc_port, FLEET_ARM_S + tail, scratch, "a1", seed=1)
        time.sleep(max(0.0, procs[0].start_at - time.time()) + FLEET_ARM_S / 2)
        # one process on the card: the owner (and this script)
        holders = [p for p in [master.pid, *pids["workers"], *(c.pid for c in procs)] if holds_card(p)]
        check(not holders, f"fleet processes other than the owner hold the card: {holders}")
        check(holds_card(pids["owner"]), "the owner holds no /dev/nvidia* file")
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        listed = {int(x) for x in smi.stdout.split() if x.strip().isdigit()}
        ours = {master.pid, *pids["workers"], *(c.pid for c in procs)}
        check(not (listed & ours), f"nvidia-smi lists fleet processes other than the owner: {listed & ours}")
        out["compute_apps"] = sorted(listed)
        out["compute_apps_known"] = sorted(listed & {pids["owner"], os.getpid()})
        time.sleep(max(0.0, procs[0].start_at + FLEET_ARM_S - time.time()) + 0.2)
        t_prof = time.time()
        captures = owner_profiles(owner_debug, env["TPU_PROFILE_DIR"], "13 (a)", FLEET_SERVED_KERNELS,
                                  load_end=procs[0].start_at + FLEET_ARM_S + tail)
        prof = captures[0]
        out["profile_at_s"] = [t_prof - procs[0].start_at, time.time() - procs[0].start_at]
        out["captures"] = [{"busy_share": c["busy_share"], "served": c["served"]} for c in captures]
        load = fleet_collect(procs, FLEET_ARM_S + tail, FLEET_ARM_S)
        after = metrics_of(owner_debug)
        check(not load["failures"], f"calls failed: {load['failures'][:5]}")
        out["exact"] = shared_exact(load, "shared:s", FLEET_SHARED_LIMIT, FLEET_SHARED_KEYS)
        launches = owner_launches(before, after)
        for kernel in ("way_scan", "slab_apply", "sketch_update"):
            check(launches.get(kernel, 0) > 0, f"the owner launched no {kernel}: {launches}")
        check(launches.get("way_scan_multi_per_item", 0) + launches.get("way_scan_multi_set_major", 0) == 0,
              f"a fixed-only fleet ran the multi way scan: {launches}")
        rings = {k: after.get(f"ratelimit_owner_shm_{k}", 0) for k in ("rings", "items_in", "items_out")}
        check(rings["rings"] >= FLEET_WORKERS and rings["items_in"] > 0 and rings["items_out"] == rings["items_in"],
              f"the shm rings did not carry the frames: {rings}")
        # the fleet's /metrics: the calls, the codec on every member, the
        # build gauges naming the card for the owner only
        merged = metrics_of(debug, "/metrics?fleet=1")
        calls_metric = int(merged.get("ratelimit_service_call_should_rate_limit_latency_ms_count", -1))
        check(calls_metric == load["calls"], f"/metrics?fleet=1 counts {calls_metric} calls, the clients sent {load['calls']}")
        members = {f"worker{i}": metrics_of(debug + 1 + i) for i in range(FLEET_WORKERS)} | {"owner": after}
        native = {m: v.get("ratelimit_native_available") for m, v in members.items()}
        check(all(v == 1 for v in native.values()), f"ratelimit_native_available is not 1 on every member: {native}")
        build = {m: (v.get("ratelimit_build_platform_id"), v.get("ratelimit_build_device_count")) for m, v in members.items()}
        check(build.pop("owner") == (2, 1) and all(b == (0, 0) for b in build.values()),
              f"the build gauges name the card on another member: {build}")
        check((merged.get("ratelimit_build_platform_id"), merged.get("ratelimit_build_device_count")) == (2, 1),
              "the merged build gauges do not name the card")
        out |= {
            "load": {k: load[k] for k in ("calls", "measured_calls", "hits", "requests_per_s", "p50_ms", "p99_ms", "seconds")},
            "owner_busy_share": float(np.median([c["busy_share"] for c in captures])), "owner_kernels": prof["kernels"],
            "owner_launches": launches, "batch_mean": batch_mean(before, after), "rings": rings,
            "native_available": native, "fleet_calls_metric": calls_metric,
        }
        out["kill"] = fleet_kill(master, pids, env, scratch)
    finally:
        if master.poll() is None:
            rc = fleet_down(master, "arm (a)")
        else:
            rc = master.returncode
    check(rc == 0, f"the fleet master exited {rc} on SIGTERM:\n{log_tail(master)}")
    left = ring_segments(pids["workers"] + ([out["kill"]["restarted_pid"]] if "kill" in out else []))
    check(not left, f"the teardown left shm segments: {left}")
    out["restore"] = fleet_restore(env, out["exact"])
    return out


def ring_segments(pids) -> list:
    """The shm ring segments in /dev/shm that the processes `pids` made: a
    producer names its segments rlring_<pid>_*."""
    return [p for p in os.listdir("/dev/shm") if any(p.startswith(f"rlring_{pid}_") for pid in pids)]


def fleet_kill(master, pids: dict, env: dict, scratch: str) -> dict:
    """The second wave of arm (a), without shared keys: SIGKILL worker 0
    in its middle. The master restarts it, the owner detaches its rings
    (its segments vanish), and the connections whose calls fail are at
    most the killed worker's, each failing at the kill: no other worker's
    call fails."""
    debug, grpc_port = int(env["DEBUG_PORT"]), int(env["GRPC_PORT"])
    procs = fleet_clients(grpc_port, FLEET_KILL_S, scratch, "a2", seed=2, shared_until=0)
    time.sleep(max(0.0, procs[0].start_at - time.time()) + FLEET_KILL_S / 3)
    victim = pids["workers"][0]
    # the most connections it held in the last ~50 ms before the kill
    held, queued = max(tcp_conns(victim, grpc_port) for _ in range(5))
    os.kill(victim, signal.SIGKILL)
    t_kill = time.time()
    wait_for(lambda: len(fleet_pids(master)["workers"]) == FLEET_WORKERS and victim not in fleet_pids(master)["workers"],
             "the master to restart the killed worker", 30, master)
    restart_s = time.time() - t_kill
    wait_for(lambda: all(http_ok(debug + 1 + i) for i in range(FLEET_WORKERS)), "the restarted worker's debug port", 120, master)
    ready_s = time.time() - t_kill
    restarted = next(p for p in fleet_pids(master)["workers"] if p not in pids["workers"])
    wait_for(lambda: not ring_segments([victim]), "the owner to detach the killed worker's rings", 30, master)
    load = fleet_collect(procs, FLEET_KILL_S)
    fails = load["failures"]
    codes = collections.Counter(f[3] for f in fails)
    # one thread a channel, one channel a connection, one call in flight
    # on each: a call can fail only on a connection the killed worker held
    # (or one still queued to a listener when it died). Such a thread
    # redials at once, and the redial can land on the killed worker's
    # listener before the kernel has closed it: its next call fails too,
    # on the same thread. So the failing threads are counted, not the calls.
    conns = collections.Counter((f[5], f[2]) for f in fails)
    check(len(conns) <= held + queued, f"calls failed on {len(conns)} connections ({len(fails)} calls), the killed "
          f"worker held {held} connections ({queued} queued): {[(round(f[1] - t_kill, 3), f[3], f[4]) for f in fails[:20]]}")
    check(set(codes) <= {"UNAVAILABLE"}, f"calls failed otherwise than UNAVAILABLE: {dict(codes)}")
    check(all(t_kill - 1.0 <= f[1] <= t_kill + 5.0 for f in fails), "a call failed away from the kill")
    return {
        "killed_pid": victim, "restarted_pid": restarted, "killed_connections": held, "queued_connections": queued,
        "failed_calls": len(fails), "failed_connections": len(conns), "max_failed_calls_per_connection": max(conns.values(), default=0),
        "failure_codes": dict(codes), "failure_details": dict(collections.Counter(f[4] for f in fails)),
        "restart_s": restart_s, "ready_s": ready_s, "calls": load["calls"], "requests_per_s": load["requests_per_s"],
    }


def fleet_restore(env: dict, exact: dict) -> dict:
    """The owner's drain snapshot restored into a fresh engine on the card:
    each shared key's counter is its calls admitted plus refused."""
    from api_ratelimit_tpu_torch.backends.cuda import SlabDeviceEngine
    from api_ratelimit_tpu_torch.models.descriptors import Entry
    from api_ratelimit_tpu_torch.ops.hashing import fingerprint64
    from api_ratelimit_tpu_torch.persist.snapshot import COL_COUNT, COL_FP_HI, COL_FP_LO
    from api_ratelimit_tpu_torch.persist.snapshotter import SlabSnapshotter
    from api_ratelimit_tpu_torch.utils import RealTimeSource

    engine = SlabDeviceEngine(RealTimeSource(), n_slots=int(env["TPU_SLAB_SLOTS"]), ways=0, device="cuda",
                              buckets=BUCKETS, hotkey_lanes=HOTKEY_LANES, hotkey_k=HOTKEY_K)
    try:
        snap = SlabSnapshotter(engine, env["SLAB_SNAPSHOT_DIR"], interval_ms=WARM_SNAPSHOT_MS, time_source=RealTimeSource())
        stats = snap.restore()
        rows = np.concatenate(engine.export_tables())
        u = rows.view(np.uint32)
        index = {(int(lo), int(hi)): int(c) for lo, hi, c in zip(u[:, COL_FP_LO], u[:, COL_FP_HI], u[:, COL_COUNT])}
        counters = {}
        for key, (ok, over) in exact.items():
            name, value = key.split(":", 1)
            fp = fingerprint64("proc", (Entry(name, value),), 3600)
            count = index.get((fp & 0xFFFFFFFF, fp >> 32))
            counters[key] = count
            check(count == ok + over, f"restored counter of {key} is {count}, its calls {ok + over}")
    finally:
        engine.close()
    return {"restored": stats.get("restored"), "counters": counters}


def owner_spawn(root: str, scratch: str, tag: str, argv: tuple = (), **overrides):
    """A device owner (sidecar_cmd) at the default deployment with the
    dispatch loop, its socket scratch/<tag>.sock, its own snapshot and
    profile directories and debug port: (process, env, debug port)."""
    env = fleet_env(root, scratch, tag, SHM_RINGS="true", **overrides)
    debug = int(env["DEBUG_PORT"]) + 1 + FLEET_WORKERS
    env["DEBUG_PORT"] = str(debug)
    proc = fleet_spawn(SIDECAR_CMD, env, os.path.join(scratch, tag + "_owner.log"), argv=argv)
    return proc, env, debug


def owners_wait(owners: list, what: str) -> float:
    """Wait until every owner's /healthcheck answers (they boot together);
    on a failure stop them all. Returns the seconds waited."""
    t0 = time.perf_counter()
    try:
        for proc, _env, debug in owners:
            wait_for(lambda debug=debug: http_ok(debug, "/healthcheck"), what, FLEET_BOOT_S, proc)
    except BaseException:
        stop_procs([o[0] for o in owners], what)
        raise
    return time.perf_counter() - t0


def fleet_owner_up(root: str, scratch: str, tag: str):
    """An external device owner (sidecar_cmd) with SHM_RINGS=true, booted
    until its /healthcheck answers: (process, its env, its debug port,
    seconds)."""
    t0 = time.perf_counter()
    owner = owner_spawn(root, scratch, tag)
    owners_wait([owner], f"{tag}: the owner")
    proc, env, debug = owner
    return proc, env, debug, time.perf_counter() - t0


def stop_procs(procs: list, tag: str) -> None:
    """SIGTERM each live process in turn and wait for it (killed after 60
    s); each must exit 0."""
    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    for proc in procs:
        check(proc.returncode == 0, f"{tag}: a process exited {proc.returncode} on SIGTERM:\n{log_tail(proc)}")


def fleet_arm_b(root: str, scratch: str, owner_env: dict, owner_debug: int) -> dict:
    """Arm (b): FRONTEND_PROCS=4, BACKEND_TYPE=cuda-sidecar against the
    external owner, the socket RPC only (SHM_RINGS=false), with a
    concurrency rule beside the fixed one: exactness on both, the owner's
    trace names the multi instantiation of the way scan once the guard has
    flipped."""
    fleet_runtime(root, conc=True)
    env = fleet_env(root, scratch, "b", "cuda-sidecar", SHM_RINGS="false", SIDECAR_SOCKET=owner_env["SIDECAR_SOCKET"])
    waited = wait_hour_margin(FLEET_ARM_S + 120)
    master, pids, boot_s = fleet_up(env, scratch, "b", FLEET_WORKERS, owner=False)
    debug, grpc_port = int(env["DEBUG_PORT"]), int(env["GRPC_PORT"])
    try:
        owner_profile(owner_debug, owner_env["TPU_PROFILE_DIR"], ms=10)
        before = metrics_of(owner_debug)
        procs = fleet_clients(grpc_port, FLEET_ARM_S + FLEET_TAIL_S, scratch, "b", seed=3, conc_keys=FLEET_CONC_KEYS)
        time.sleep(max(0.0, procs[0].start_at + FLEET_ARM_S - time.time()) + 0.2)
        prof = owner_profile(owner_debug, owner_env["TPU_PROFILE_DIR"], load_end=procs[0].start_at + FLEET_ARM_S + FLEET_TAIL_S)
        load = fleet_collect(procs, FLEET_ARM_S + FLEET_TAIL_S, FLEET_ARM_S)
        after = metrics_of(owner_debug)
        check(not load["failures"], f"calls failed: {load['failures'][:5]}")
        exact = shared_exact(load, "shared:s", FLEET_SHARED_LIMIT, FLEET_SHARED_KEYS)
        exact |= shared_exact(load, "conc:c", FLEET_CONC_CAP, FLEET_CONC_KEYS)
        check(named(prof["kernels"], "way_scan_kernel<true>") > 0, f"the owner's trace names no multi way scan: {prof['kernels']}")
        launches = owner_launches(before, after)
        check(launches.get("way_scan_multi_per_item", 0) + launches.get("way_scan_multi_set_major", 0) > 0,
              f"the owner ran no multi way scan: {launches}")
        check(after.get("ratelimit_owner_shm_rings", 0) == 0, "SHM_RINGS=false attached rings")
        shm_active = [metrics_of(debug + 1 + i).get("ratelimit_sidecar_shm_active") for i in range(FLEET_WORKERS)]
        check(all(v == 0 for v in shm_active), f"a worker used the shm rings: {shm_active}")
    finally:
        rc = fleet_down(master, "arm (b)") if master.poll() is None else master.returncode
    check(rc == 0, f"the fleet master exited {rc} on SIGTERM:\n{log_tail(master)}")
    return {
        "boot_s": boot_s, "hour_wait_s": waited, "exact": exact,
        "load": {k: load[k] for k in ("calls", "measured_calls", "hits", "requests_per_s", "p50_ms", "p99_ms", "seconds")},
        "owner_busy_share": prof["busy_share"], "owner_kernels": prof["kernels"], "owner_launches": launches,
        "batch_mean": batch_mean(before, after),
    }


def fleet_single(root: str, scratch: str, tag: str, owner_env: dict | None = None, owner_debug: int = 0) -> dict:
    """One run of (c) under arm (a)'s client load: the single-process
    Runner (service_cmd, BACKEND_TYPE=cuda), or, given an external owner's
    env and debug port, one cuda-sidecar worker against it (its segments
    gone after its SIGTERM). requests/s, p50/p99 per call, the card's busy
    share in a trace of the process holding it, the mean batch per
    launch."""
    fleet_runtime(root)
    if owner_env is None:
        env = fleet_env(root, scratch, tag)
        owner_debug, profile_dir = int(env["DEBUG_PORT"]), env["TPU_PROFILE_DIR"]
        worker_env = {}
    else:
        env = fleet_env(root, scratch, tag, "cuda-sidecar", SHM_RINGS="true", SIDECAR_SOCKET=owner_env["SIDECAR_SOCKET"])
        profile_dir = owner_env["TPU_PROFILE_DIR"]
        worker_env = {"CUDA_VISIBLE_DEVICES": ""}
    debug, grpc_port = int(env["DEBUG_PORT"]), int(env["GRPC_PORT"])
    worker = fleet_spawn(SERVICE_CMD, env, os.path.join(scratch, tag + "_worker.log"), **worker_env)
    try:
        wait_for(lambda: http_ok(debug), f"{tag}: the server", FLEET_BOOT_S, worker)
        wait_for(lambda: grpc_health(grpc_port) == 1, f"{tag}: gRPC SERVING", 60, worker)
        owner_profile(owner_debug, profile_dir, ms=10)
        before = metrics_of(owner_debug)
        procs = fleet_clients(grpc_port, FLEET_C_S + FLEET_TAIL_S, scratch, tag, seed=4)
        time.sleep(max(0.0, procs[0].start_at + FLEET_C_S - time.time()) + 0.2)
        prof = owner_profile(owner_debug, profile_dir, load_end=procs[0].start_at + FLEET_C_S + FLEET_TAIL_S)
        load = fleet_collect(procs, FLEET_C_S + FLEET_TAIL_S, FLEET_C_S)
        after = metrics_of(owner_debug)
        check(not load["failures"], f"{tag}: calls failed: {load['failures'][:5]}")
    finally:
        stop_procs([worker], tag)
    if owner_env is not None:
        check(after.get("ratelimit_owner_shm_rings", 0) > 0, f"{tag}: the worker attached no shm ring")
        left = ring_segments([worker.pid])
        check(not left, f"{tag}: the worker's teardown left shm segments: {left}")
    return {
        "requests_per_s": load["requests_per_s"], "p50_ms": load["p50_ms"], "p99_ms": load["p99_ms"],
        "calls": load["measured_calls"], "busy_share": prof["busy_share"], "batch_mean": batch_mean(before, after),
    }


def fleet_leases(K, root: str, scratch: str) -> dict:
    """(d): one cuda-sidecar frontend with LEASE_ENABLED true and the same
    with it false, each against its own device owner on the card (served
    in this process, so its launches count here), one fake clock that does
    not move: one sequential stream of single-hit v3 calls on LEASE_KEYS,
    limits crossed, answered byte for byte alike; the lease arm launches
    less and its owner's registry holds liabilities."""
    from api_ratelimit_tpu_torch.backends.sidecar import SlabSidecarServer
    from api_ratelimit_tpu_torch.cmd.sidecar_cmd import build_engine
    from api_ratelimit_tpu_torch.settings import new_settings
    from api_ratelimit_tpu_torch.stats import Store
    from api_ratelimit_tpu_torch.stats.sinks import NullSink
    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    process_runtime(root)
    reqs = lease_requests(np.random.default_rng(43), FLEET_LEASE_CALLS)
    install_process_time_source(FakeTimeSource(NOW0))
    owners, runners, got, launches = {}, [], {}, {}
    try:
        for arm, lease in (("lease_off", "false"), ("lease_on", "true")):
            sock = os.path.join(scratch, f"d_{arm}.sock")
            env = process_env(root, SIDECAR_SOCKET=sock)
            engine = build_engine(new_settings(env), Store(NullSink()).scope("ratelimit"))
            owners[arm] = SlabSidecarServer(sock, engine, shm_control_path=sock + ".shmctl")
            owners[arm].engine = engine
            runner, _ = process_boot(process_env(root, backend="cuda-sidecar", SIDECAR_SOCKET=sock, LEASE_ENABLED=lease))
            runners.append(runner)
            check((runner.lease_table is not None) == (lease == "true"), f"{arm}: LEASE_ENABLED={lease} built the wrong table")
            first = len(engine.launch_sizes)
            got[arm], launches[arm] = lease_run(K, runner, reqs)
            launches[arm]["engine"] = len(engine.launch_sizes) - first
        check(got["lease_on"] == got["lease_off"], "the lease arm's answers over the wire differ from the lease-off arm's")
        codes = collections.Counter(v for raw in got["lease_on"] for v in verdicts(raw))
        check(codes[1] > 0 and codes[2] > 0, f"the lease stream did not cross a limit: {dict(codes)}")
        on, off = launches["lease_on"]["engine"], launches["lease_off"]["engine"]
        check(on < off == len(reqs), f"owner launches: {on} with leases, {off} without")
        if engine.device.type == "cuda":
            # the owner serves in this process: its kernels count here
            applies = launches["lease_on"]["slab_apply"], launches["lease_off"]["slab_apply"]
            check(applies == (on, off), f"the owner's apply launches {applies}, its launches {(on, off)}")
        local_hits = runners[1].stats_store.debug_snapshot().get("ratelimit.lease.local_hits", 0)
        outstanding = owners["lease_on"].engine.lease_registry.outstanding()
        check(local_hits > 0 and outstanding[0] > 0 and outstanding[1] > 0,
              f"no lease answered or none is outstanding: {local_hits} {outstanding}")
    finally:
        for r in runners:
            r.stop()
        for server in owners.values():
            server.close()
        install_process_time_source(RealTimeSource())
    return {"calls": len(reqs), "codes": dict(codes), "owner_slab_apply": {"lease_on": on, "lease_off": off},
            "local_hits": local_hits, "outstanding": list(outstanding)}


def phase_fleet(K) -> dict:
    """Phase 13 (module docstring)."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as scratch:
        root = os.path.join(scratch, "runtime")
        t = time.perf_counter()
        out["a"] = fleet_arm_a(root, scratch)
        out["a"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        single = fleet_single(root, scratch, "c1")
        single["seconds"] = time.perf_counter() - t
        # one external owner serves (b), then (c)'s one-worker run: (b)
        # counts its shared keys from zero, (c) checks no key's exactness
        t = time.perf_counter()
        owner, owner_env, owner_debug, owner_boot_s = fleet_owner_up(root, scratch, "bc")
        try:
            out["b"] = fleet_arm_b(root, scratch, owner_env, owner_debug)
            out["b"]["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            one_worker = fleet_single(root, scratch, "c2", owner_env, owner_debug)
        finally:
            stop_procs([owner], "the external owner")
        one_worker["seconds"] = time.perf_counter() - t
        out["b"]["owner_boot_s"] = owner_boot_s
        out["c"] = {
            "single_process": single,
            "one_worker_sidecar": one_worker,
            "fleet_4": {
                "requests_per_s": out["a"]["load"]["requests_per_s"], "p50_ms": out["a"]["load"]["p50_ms"],
                "p99_ms": out["a"]["load"]["p99_ms"], "calls": out["a"]["load"]["measured_calls"],
                "busy_share": out["a"]["owner_busy_share"], "batch_mean": out["a"]["batch_mean"],
            },
        }
        out["d"] = fleet_leases(K, os.path.join(scratch, "runtime_d"), scratch)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 14: warm-standby replication and the partitioned cluster ----------

REPL_INTERVAL_MS = 100  # REPL_INTERVAL_MS of every replicated owner
REPL_LOAD_S = 6.0  # (a)'s clean-handoff load, measured
# the clean arm's shared limit: every key must cross it in REPL_LOAD_S at
# the replicated fleet's rate (a key got 11-38 calls at 468-835 calls/s)
REPL_CLEAN_LIMIT = 4
REPL_CRASH_S = 8.0  # the crash arm's load
REPL_KILL_AT_S = 4.0  # the primary is SIGKILLed this far into it
# an answer the primary sent before it died reaches its client up to this
# long after (the frontend relays it): such admissions count as the
# primary's in the crash arm's bound
REPL_RELAY_S = 0.05
# the crash arm's shared limit: what (a)'s rate admits a key this long
# after the kill, so the keys cross it after the failover
REPL_CROSS_AFTER_S = 1.5
REPL_LAG_SAMPLES = 5
CLUSTER_ROUTE_SETS = 256
CLUSTER_V3_CALLS = 1024
CLUSTER_V2_CALLS = 64
CLUSTER_JSON_CALLS = 64
CLUSTER_LOAD_S = 8.0
CLUSTER_RESHARD_AT_S = 3.0  # the reshard starts this far into the load
CLUSTER_SHARED_LIMIT = 1_000_000  # the shared keys never refuse: limit_remaining reads their counter
# hour windows only: the owners' real clocks and the frontends' fake one
# roll no window during the phase (wait_hour_margin)
CLUSTER_RULES = f"""\
domain: proc
descriptors:
  - key: user
    rate_limit: {{unit: hour, requests_per_unit: 20}}
  - key: tenant
    descriptors:
      - key: path
        rate_limit: {{unit: hour, requests_per_unit: 400}}
  - key: ip
    rate_limit: {{unit: hour, requests_per_unit: 10}}
  - key: shared
    rate_limit: {{unit: hour, requests_per_unit: {CLUSTER_SHARED_LIMIT}}}
"""


def repl_rules(root: str, limit: int) -> None:
    config = os.path.join(root, "ratelimit", "config")
    os.makedirs(config, exist_ok=True)
    write_text(os.path.join(config, "proc.yaml"), PROCESS_RULES + f"""\
  - key: shared
    rate_limit: {{unit: hour, requests_per_unit: {limit}}}
""")


def repl_pair_spawn(root: str, scratch: str, tag: str, spawned: list) -> dict:
    """A primary and a standby on the card (--role primary / standby, both
    with SIDECAR_ADDRS=P,S, REPL_INTERVAL_MS), started together; each
    process also goes to `spawned`."""
    p_sock, s_sock = os.path.join(scratch, tag + "p.sock"), os.path.join(scratch, tag + "s.sock")
    common = {"SIDECAR_ADDRS": f"{p_sock},{s_sock}", "REPL_INTERVAL_MS": str(REPL_INTERVAL_MS)}
    p = owner_spawn(root, scratch, tag + "p", ("--role", "primary"), **common)
    s = owner_spawn(root, scratch, tag + "s", ("--role", "standby"), **common)
    spawned += [p[0], s[0]]
    return {"tag": tag, "p": p, "s": s, "p_sock": p_sock, "s_sock": s_sock, "addrs": common["SIDECAR_ADDRS"],
            "t0": time.perf_counter()}


def repl_pair_ready(pair: dict) -> dict:
    """Wait for a spawned pair: both healthy and the standby's first
    (full snapshot) frame applied; adds the seconds from the spawn."""
    tag, p, s = pair["tag"], pair["p"], pair["s"]
    owners_wait([p, s], f"{tag}: the replicated pair")
    pair["boot_s"] = time.perf_counter() - pair["t0"]
    try:
        wait_for(lambda: metrics_of(s[2]).get("ratelimit_repl_frames_applied", 0) >= 1,
                 f"{tag}: the standby's first frame", 120, s[0])
    except BaseException:
        stop_procs([p[0], s[0]], tag)
        raise
    pair["synced_s"] = time.perf_counter() - pair["t0"]
    return pair


def repl_frontend_up(root: str, scratch: str, tag: str, pair: dict):
    """A cuda-sidecar master of FLEET_WORKERS workers whose SIDECAR_ADDRS is
    the pair (primary first): socket RPC only, the epoch fence on every
    frame. Returns (master, pids, env, boot seconds)."""
    env = fleet_env(root, scratch, tag, "cuda-sidecar", SHM_RINGS="false", SIDECAR_SOCKET=pair["p_sock"],
                    SIDECAR_ADDRS=pair["addrs"])
    master, pids, boot_s = fleet_up(env, scratch, tag, FLEET_WORKERS, owner=False)
    return master, pids, env, boot_s


def hist_bound_ms(metrics: dict, name: str) -> float:
    """An upper bound on every sample of histogram `name` in a /metrics
    read: the least bucket edge that holds them all (infinite when one
    passed the last edge)."""
    total = metrics.get(name + "_count", 0)
    head = name + '_bucket{le="'
    edges = [float(k[len(head):-2]) for k, v in metrics.items()
             if k.startswith(head) and k != head + '+Inf"}' and v >= total]
    return min(edges, default=math.inf)


def repl_figures(before: dict, after: dict, seconds: float) -> dict:
    """The primary's ship loop between two /metrics reads: delta frames a
    second, bytes a frame, and the export drain and diff_tables ms an
    interval."""
    def d(name):
        return after.get(name, 0) - before.get(name, 0)

    frames = d("ratelimit_repl_frames_shipped")
    n_exp = d("ratelimit_repl_ship_export_ms_count")
    return {
        "frames": int(frames), "frames_per_s": frames / seconds if seconds else 0.0,
        "bytes_per_frame": d("ratelimit_repl_bytes_shipped") / frames if frames else None,
        "export_ms": d("ratelimit_repl_ship_export_ms_sum") / n_exp if n_exp else None,
        "diff_ms": d("ratelimit_repl_ship_diff_ms_sum") / n_exp if n_exp else None,
    }


def owner_kernels_ran(label: str, before: dict, after: dict) -> dict:
    launches = owner_launches(before, after)
    for kernel in ("way_scan", "slab_apply", "sketch_update"):
        check(launches.get(kernel, 0) > 0, f"{label}: no {kernel} launch: {launches}")
    return launches


def load_slab_file(directory: str) -> np.ndarray:
    from api_ratelimit_tpu_torch.persist.snapshot import load_snapshot
    from api_ratelimit_tpu_torch.persist.snapshotter import snapshot_paths

    (path,) = snapshot_paths(directory, 1)
    _header, table = load_snapshot(path)
    return np.asarray(table, dtype=np.uint32)


def repl_clean(root: str, scratch: str, fleet_b_rps: float | None, pair: dict, after_load=None) -> dict:
    """(a), the clean handoff: load through a four-worker frontend of the
    pair, the lag and the ship loop's cost read meanwhile; the load stops,
    three intervals pass, P takes SIGTERM (its drain snapshot is its last
    table), and a zero-hit write promotes S. S's table (its drain
    snapshot) equals reconcile_rows of P's, bit for bit, but for the
    probe key's row. after_load() runs once the load's figures are read
    (the next arm's owners start booting)."""
    from api_ratelimit_tpu_torch.backends.sidecar import SidecarEngineClient
    from api_ratelimit_tpu_torch.persist.snapshot import reconcile_rows

    repl_rules(root, REPL_CLEAN_LIMIT)
    repl_pair_ready(pair)
    (p, p_env, p_dbg), (s, s_env, s_dbg) = pair["p"], pair["s"]
    out = {"boot_s": pair["boot_s"], "synced_s": pair["synced_s"]}
    master = None
    try:
        # the frontend's boot and the load inside one clock hour
        out["hour_wait_s"] = wait_hour_margin(REPL_LOAD_S + 120)
        master, _pids, _env, out["frontend_boot_s"] = repl_frontend_up(root, scratch, "r1f", pair)
        grpc_port = int(_env["GRPC_PORT"])
        before = metrics_of(p_dbg)
        s_before = metrics_of(s_dbg)
        procs = fleet_clients(grpc_port, REPL_LOAD_S, scratch, "r1", seed=11)
        time.sleep(max(0.0, procs[0].start_at - time.time()) + 1.0)
        lag = {"p": [], "s": []}
        for _ in range(REPL_LAG_SAMPLES):
            lag["p"].append(metrics_of(p_dbg).get("ratelimit_repl_lag_ms"))
            lag["s"].append(metrics_of(s_dbg).get("ratelimit_repl_lag_ms"))
            time.sleep((REPL_LOAD_S - 2.0) / REPL_LAG_SAMPLES)
        load = fleet_collect(procs, REPL_LOAD_S)
        after = metrics_of(p_dbg)
        check(not load["failures"], f"(a) calls failed: {load['failures'][:5]}")
        out["exact"] = shared_exact(load, "shared:s", REPL_CLEAN_LIMIT, FLEET_SHARED_KEYS)
        out["load"] = {k: load[k] for k in ("calls", "hits", "requests_per_s", "p50_ms", "p99_ms", "seconds")}
        out["phase13_b_requests_per_s"] = fleet_b_rps
        out["lag_ms"] = lag
        out["ship"] = repl_figures(before, after, load["seconds"])
        out["p_launches"] = owner_kernels_ran("(a) the primary", before, after)
        if after_load is not None:
            after_load()
        rc = fleet_down(master, "(a) the frontend")
        check(rc == 0, f"(a) the frontend master exited {rc}")
        master = None
        # three intervals, then the standby holds every shipped frame
        time.sleep(3 * REPL_INTERVAL_MS / 1e3)
        wait_for(lambda: metrics_of(s_dbg).get("ratelimit_repl_frames_applied", 0)
                 >= metrics_of(p_dbg).get("ratelimit_repl_frames_shipped", 0),
                 "(a) the standby to apply every shipped frame", 30, s)
        out["repl_p"] = {k: metrics_of(p_dbg).get(f"ratelimit_repl_{k}") for k in ("epoch", "frames_shipped", "standbys")}
        stop_procs([p], "(a) the primary")
        probe_fp = 0x5EED_0001_0000_0007
        client = SidecarEngineClient(pair["addrs"], retries=1, breaker_threshold=0)
        try:
            t_lo = int(time.time())
            block = np.array([[probe_fp & 0xFFFFFFFF], [probe_fp >> 32], [0], [100], [3600], [0]], dtype=np.uint32)
            probe = client.submit_rows(block).tolist()
            t_hi = int(time.time())
            check(client.active_address == pair["s_sock"], "(a) the zero-hit write did not reach the standby")
        finally:
            client.close()
        s_after = metrics_of(s_dbg)
        out["repl_s"] = {k: s_after.get(f"ratelimit_repl_{k}") for k in ("epoch", "promotions", "promotion_ms", "frames_applied", "resyncs")}
        check(out["repl_s"]["epoch"] == 2 and out["repl_s"]["promotions"] == 1,
              f"(a) the standby did not promote once to epoch 2: {out['repl_s']}")
        out["probe_answer"] = probe
        out["s_launches"] = owner_kernels_ran("(a) the promoted standby", s_before, s_after)
        stop_procs([s], "(a) the promoted standby")
    finally:
        if master is not None and master.poll() is None:
            fleet_down(master, "(a) the frontend")
        stop_procs([x for x in (p, s) if x.poll() is None], "(a) the pair")
    last = load_slab_file(p_env["SLAB_SNAPSHOT_DIR"])
    promoted = load_slab_file(s_env["SLAB_SNAPSHOT_DIR"])
    probe_row = (promoted[:, 0] == (probe_fp & 0xFFFFFFFF)) & (promoted[:, 1] == (probe_fp >> 32))
    check(int(probe_row.sum()) <= 1, "(a) the probe key holds more than one row")
    masked = promoted.copy()
    masked[probe_row] = 0
    match = None
    for t in range(t_lo, t_hi + 1):
        want, stats = reconcile_rows(last, t)
        if np.array_equal(masked, want):
            match = (t, stats)
            break
    check(match is not None, "(a) the promoted slab is not reconcile_rows of the primary's last table")
    out["handoff"] = {"primary_rows": int(last.any(axis=1).sum()), "reconciled_at": match[0],
                      "restored": match[1]["restored"],
                      "dropped": match[1]["dropped_expired"] + match[1]["dropped_window"], "bit_equal": True}
    return out


def repl_crash(root: str, scratch: str, per_key_rate: float, pair: dict, spawned: list, after_load=None) -> dict:
    """(a), the crash: a fresh pair and frontend, load with every shared
    call logged, SIGKILL P in its middle. No call fails; every shared key
    admits at least what an uninterrupted limiter would (min(limit,
    calls)), and past its limit by at most what P may have admitted it
    after the last frame S received: its calls P answered OK in the window
    that ship could have missed (REPL_INTERVAL_MS plus twice the largest
    export and diff, bucket edges of P's /metrics histograms), and its
    calls P took before the kill but never answered (S answered their
    retries). Then the old P boots again and refuses a write stamped with
    the promoted epoch. after_load() runs once the load is collected."""
    limit = max(4, int(round(per_key_rate * (REPL_KILL_AT_S + REPL_CROSS_AFTER_S))))
    repl_rules(root, limit)
    repl_pair_ready(pair)
    (p, p_env, p_dbg), (s, s_env, s_dbg) = pair["p"], pair["s"]
    out = {"boot_s": pair["boot_s"], "synced_s": pair["synced_s"], "shared_limit": limit}
    master = p2 = None
    try:
        out["hour_wait_s"] = wait_hour_margin(REPL_CRASH_S + 120)
        master, _pids, env, out["frontend_boot_s"] = repl_frontend_up(root, scratch, "r2f", pair)
        before = metrics_of(p_dbg)
        s_before = metrics_of(s_dbg)
        procs = fleet_clients(int(env["GRPC_PORT"]), REPL_CRASH_S, scratch, "r2", seed=12)
        time.sleep(max(0.0, procs[0].start_at + REPL_KILL_AT_S - time.time()))
        last_p = metrics_of(p_dbg)
        t_kill = time.time()
        p.kill()
        p.wait()
        t_dead = time.time()
        # the old primary comes back at once, at its socket, with its role
        p2 = owner_spawn(root, scratch, pair["tag"] + "p", ("--role", "primary"), SIDECAR_ADDRS=pair["addrs"],
                         REPL_INTERVAL_MS=str(REPL_INTERVAL_MS),
                         SLAB_SNAPSHOT_DIR=os.path.join(scratch, pair["tag"] + "p_again_snap"))
        spawned.append(p2[0])
        load = fleet_collect(procs, REPL_CRASH_S)
        s_after = metrics_of(s_dbg)
        if after_load is not None:
            after_load()
        check(not load["failures"], f"(a) crash: {len(load['failures'])} calls failed: {load['failures'][:5]}")
        ship = repl_figures(before, last_p, t_kill - procs[0].start_at)
        cycle_ms = hist_bound_ms(last_p, "ratelimit_repl_ship_export_ms") + hist_bound_ms(last_p, "ratelimit_repl_ship_diff_ms")
        window_s = (REPL_INTERVAL_MS + 2 * cycle_ms) / 1e3
        keys = {}
        for j in range(FLEET_SHARED_KEYS):
            key = f"shared:s{j}"
            ok, over = load["shared"][key], load["over"][key]
            late = sum(1 for k, _t0, t1, was_ok in load["shared_calls"]
                       if k == key and was_ok and t_kill - window_s < t1 <= t_dead + REPL_RELAY_S)
            unanswered = sum(1 for k, t0, t1, _ok in load["shared_calls"]
                             if k == key and t0 <= t_kill and t1 > t_dead + REPL_RELAY_S)
            keys[key] = {"ok": ok, "over": over, "last_window_ok": late, "unanswered_by_p": unanswered}
            check(ok >= min(limit, ok + over), f"(a) crash: {key} admitted {ok} of {ok + over} calls, limit {limit}: a loss failed closed")
            check(ok - limit <= late + unanswered, f"(a) crash: {key} overshot its limit {limit} by {ok - limit}, "
                  f"more than its {late} admissions in the last {window_s * 1e3:.0f} ms before the kill "
                  f"(and the {(t_dead - t_kill) * 1e3:.0f} ms it took to die) and its {unanswered} calls P never answered")
        spanning = [t0 + ms / 1e3 - t_kill for t0, ms in load["answered"] if t0 < t_kill < t0 + ms / 1e3]
        after_kill = [t0 + ms / 1e3 - t_kill for t0, ms in load["answered"] if t0 >= t_kill]
        out |= {
            "calls": load["calls"], "requests_per_s": load["requests_per_s"], "keys": keys,
            "overshoot": {k: max(0, v["ok"] - limit) for k, v in keys.items()}, "window_ms": window_s * 1e3,
            "cycle_bound_ms": cycle_ms,
            "kill_to_dead_ms": (t_dead - t_kill) * 1e3,
            "kill_to_first_standby_answer_s": min(after_kill) if after_kill else None,
            "longest_call_across_the_kill_s": max(spanning) if spanning else None,
            "calls_across_the_kill": len(spanning),
            "repl_s": {k: s_after.get(f"ratelimit_repl_{k}") for k in ("epoch", "promotions", "promotion_ms", "frames_applied", "resyncs")},
            "ship_before_kill": ship,
        }
        check(out["repl_s"]["promotions"] == 1 and out["repl_s"]["epoch"] == 2, f"(a) crash: the standby's repl state {out['repl_s']}")
        out["s_launches"] = owner_kernels_ran("(a) crash: the promoted standby", s_before, s_after)
        rc = fleet_down(master, "(a) crash: the frontend")
        check(rc == 0, f"(a) crash: the frontend master exited {rc}")
        master = None
        out["split_brain"] = repl_split_brain(p2, int(out["repl_s"]["epoch"]))
    finally:
        if master is not None and master.poll() is None:
            fleet_down(master, "(a) crash: the frontend")
        stop_procs([x for x in (s, p2[0] if p2 else None) if x is not None and x.poll() is None], "(a) crash: the owners")
    return out


def repl_split_brain(p2, epoch: int) -> dict:
    """The old primary, booted again at epoch 1, answers a raw SUBMIT
    stamped with the promoted epoch with STATUS_STALE_EPOCH and its own
    epoch, counts it in repl.stale_epoch_rejected, and launches nothing."""
    import socket

    from api_ratelimit_tpu_torch.backends import sidecar as SC

    proc, env, debug = p2
    boot_s = owners_wait([p2], "(a) the resurrected primary")
    before = metrics_of(debug)
    block = np.array([[77], [0], [1], [100], [3600], [0]], dtype=np.uint32)
    request = SC._HDR.pack(SC.MAGIC, SC.VERSION, SC.OP_SUBMIT, SC.FLAG_EPOCH) + SC._U32.pack(1) + block.tobytes() + SC._U32.pack(epoch)
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(30)
    conn.connect(env["SIDECAR_SOCKET"])
    try:
        conn.sendall(request)
        reply = SC._recv_exact(conn, 5)
    finally:
        conn.close()
    after = metrics_of(debug)
    check(reply[0] == SC.STATUS_STALE_EPOCH and reply[1:] == SC._U32.pack(1),
          f"the resurrected primary answered {reply!r} to an epoch-{epoch} write")
    rejected = after.get("ratelimit_repl_stale_epoch_rejected", 0)
    check(rejected == 1, f"repl.stale_epoch_rejected reads {rejected}")
    launched = owner_launches(before, after)
    check(not any(launched.values()), f"the refused write launched kernels: {launched}")
    return {"boot_s": boot_s, "reply_status": reply[0], "server_epoch": 1, "write_epoch": epoch,
            "stale_epoch_rejected": rejected}


def partition_addrs(scratch: str, tags: list) -> str:
    """PARTITION_ADDRS of one owner a group, the owners' sockets by tag."""
    return ";".join(os.path.join(scratch, t + ".sock") for t in tags)


def cluster_owners_spawn(root: str, scratch: str, spawned: list) -> list:
    """(b)'s owners, started together: two on the two-partition map, the
    third on the three-partition one (each finds its partition in
    PARTITION_ADDRS by its socket)."""
    tags = ["k0", "k1", "k2"]
    two, three = partition_addrs(scratch, tags[:2]), partition_addrs(scratch, tags)
    owners = [
        owner_spawn(root, scratch, t, PARTITIONS=str(k), PARTITION_ADDRS=addrs, PARTITION_ROUTE_SETS=str(CLUSTER_ROUTE_SETS))
        for t, k, addrs in (("k0", 2, two), ("k1", 2, two), ("k2", 3, three))
    ]
    spawned += [o[0] for o in owners]
    return owners


def cluster_phase(root: str, scratch: str, owners: list, t_spawn: float) -> dict:
    """(b): two partition owners (PARTITIONS=2, PARTITION_ROUTE_SETS=256, no
    standbys) and a third holding the three-partition map boot together; a
    cuda-sidecar Runner with PARTITIONS=2 in this process beside a memory
    Runner, both on one fake clock: phase 9's stream answered byte for byte
    alike. Then fleet load through the partitioned Runner and a live 2 -> 3
    reshard in its middle: no call fails, sets move, the router adopts the
    new epoch, and each shared key's counter lies in [n - m, n], m its own
    calls answered after the first map install and started before the
    drain's last merge returned: the only writes the drain's
    keep-the-newest merge can drop are the target's from the flip to that
    merge (cluster/reshard.py)."""
    from api_ratelimit_tpu_torch.backends.sidecar import OP_MAP_SET, cluster_rpc
    from api_ratelimit_tpu_torch.cluster.partition_map import PartitionMap
    from api_ratelimit_tpu_torch.cluster.reshard import ReshardCoordinator
    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    config = os.path.join(root, "ratelimit", "config")
    os.makedirs(config, exist_ok=True)
    write_text(os.path.join(config, "proc.yaml"), CLUSTER_RULES)
    tags = ["k0", "k1", "k2"]
    two = partition_addrs(scratch, tags[:2])
    owners_wait(owners, "(b) the partition owners")
    out = {"boot_s": time.perf_counter() - t_spawn}
    runners = []
    try:
        out["hour_wait_s"] = wait_hour_margin(CLUSTER_LOAD_S + 120)
        install_process_time_source(FakeTimeSource(NOW0))
        card, card_boot = process_boot(process_env(root, backend="cuda-sidecar", PARTITIONS="2", PARTITION_ADDRS=two,
                                                   PARTITION_ROUTE_SETS=str(CLUSTER_ROUTE_SETS)))
        runners.append(card)
        host, _ = process_boot(process_env(root, backend="memory"))
        runners.append(host)
        router = card.cache.engine
        check(type(router).__name__ == "PartitionedEngineClient", f"PARTITIONS=2 built {type(router).__name__}")
        befores = [metrics_of(o[2]) for o in owners]
        t = time.perf_counter()
        out["parity"] = process_stream(card, host, types.SimpleNamespace(advance=lambda s: None), CLUSTER_V3_CALLS,
                                       CLUSTER_V2_CALLS, CLUSTER_JSON_CALLS, PROCESS_KEYS, seed=14)
        out["parity"]["seconds"] = time.perf_counter() - t
        out["parity_launches"] = {t: owner_kernels_ran(f"(b) parity: {t}", befores[i], metrics_of(owners[i][2]))
                                  for i, t in enumerate(tags[:2])}
        mid = [metrics_of(o[2]) for o in owners]
        pmap2 = PartitionMap.even_map([[owners[0][1]["SIDECAR_SOCKET"]], [owners[1][1]["SIDECAR_SOCKET"]]],
                                      route_sets=CLUSTER_ROUTE_SETS)
        pmap3 = pmap2.reshard_to([[o[1]["SIDECAR_SOCKET"]] for o in owners])
        check(router.map_epoch() == pmap2.epoch, "the router did not boot on the two-partition map")
        procs = fleet_clients(card.server.grpc_port, CLUSTER_LOAD_S, scratch, "k", seed=15)
        time.sleep(max(0.0, procs[0].start_at + CLUSTER_RESHARD_AT_S - time.time()))
        marks = {}

        def rpc(addr, op, payload):
            # the clock before the first map install (the flip) and after
            # the last reply (the drain's last merge)
            if op == OP_MAP_SET:
                marks.setdefault("flip", time.time())
            reply = cluster_rpc(addr, op, payload)
            marks["done"] = time.time()
            return reply

        t_r = time.perf_counter()
        # RESHARD_RATE_LIMIT_MB_S at its default throttles the sections
        report = ReshardCoordinator(pmap2, pmap3, rate_limit_mb_s=card.settings.cluster_config()[3], rpc=rpc).run()
        reshard_wall_s = time.perf_counter() - t_r
        load = fleet_collect(procs, CLUSTER_LOAD_S)
        check(not load["failures"], f"(b) {len(load['failures'])} calls failed: {load['failures'][:5]}")
        check(report["sets_moved"] > 0, f"(b) the reshard moved no set: {report}")
        check(router.map_epoch() == pmap3.epoch, f"(b) the router is at map epoch {router.map_epoch()}, not {pmap3.epoch}")
        counters = {}
        for j in range(FLEET_SHARED_KEYS):
            key = f"shared:s{j}"
            n = load["shared"][key] + load["over"][key]
            exposed = sum(1 for k, t0, t1, _ok in load["shared_calls"]
                          if k == key and t1 >= marks["flip"] and t0 <= marks["done"])
            code, statuses = v3_verdict(card.server.grpc_port, [("shared", f"s{j}")])
            final = CLUSTER_SHARED_LIMIT - statuses[0][2] - 1
            counters[key] = [n, final, exposed]
            check(code == "OK" and n - exposed <= final <= n,
                  f"(b) {key}: {n} calls, final counter {final}, {exposed} calls across the flip and drain")
        afters = [metrics_of(o[2]) for o in owners]
        out["reshard"] = {
            "report": report, "wall_s": reshard_wall_s, "counters": counters,
            "flip_to_drain_ms": (marks["done"] - marks["flip"]) * 1e3,
            "load": {k: load[k] for k in ("calls", "hits", "requests_per_s", "p50_ms", "p99_ms", "seconds")},
            "merge_lock": {t: {"count": a.get("ratelimit_owner_merge_count"), "total_ms": a.get("ratelimit_owner_merge_total_us", 0) / 1e3,
                               "max_ms": a.get("ratelimit_owner_merge_max_us", 0) / 1e3} for t, a in zip(tags, afters)},
        }
        check(afters[2].get("ratelimit_owner_merge_count", 0) > 0, "(b) the joining owner merged no section")
        out["launches"] = {t: owner_kernels_ran(f"(b) load: {t}", m, a) for t, m, a in zip(tags, mid, afters)}
        out["owners"] = {}
        for t, o, a in zip(tags, owners, afters):
            status, body = http_call(o[2], "GET", "/debug/cluster")
            check(status == 200, f"(b) {t}: /debug/cluster answered {status}")
            doc = json.loads(body)
            check(doc["map_epoch"] == pmap3.epoch, f"(b) {t} holds map epoch {doc['map_epoch']}")
            out["owners"][t] = {"partition": doc["partition"], "map_epoch": doc["map_epoch"],
                                "owned_range": [doc["owned_range"]["lo"], doc["owned_range"]["hi"]],
                                "metrics_map_epoch": a.get("ratelimit_cluster_map_epoch"),
                                "misrouted_rejected": a.get("ratelimit_cluster_misrouted_rejected"),
                                "stale_map_rejected": a.get("ratelimit_cluster_stale_map_rejected")}
        out["router"] = {"map_epoch": router.map_epoch(), "partitions": len(router.pmap)}
    finally:
        for r in runners:
            r.stop()
        install_process_time_source(RealTimeSource())
        stop_procs([o[0] for o in owners], "(b) the partition owners")
    return out


def phase_cluster(fleet_b_rps: float | None = None) -> dict:
    """Phase 14 (module docstring)."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    spawned: list = []
    # each arm's owners start booting once the arm before has read its
    # load's figures, so their boot overlaps its handoff and teardown
    nxt: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as scratch:
        root, root_b = os.path.join(scratch, "runtime"), os.path.join(scratch, "runtime_b")
        try:
            t = time.perf_counter()
            first = repl_pair_spawn(root, scratch, "r1", spawned)
            out["a_clean"] = repl_clean(
                root, scratch, fleet_b_rps, first,
                after_load=lambda: nxt.setdefault("pair", repl_pair_spawn(root, scratch, "r2", spawned)),
            )
            out["a_clean"]["seconds"] = time.perf_counter() - t
            clean = out["a_clean"]["load"]
            per_key = clean["calls"] / FLEET_SHARED_EVERY / FLEET_SHARED_KEYS / clean["seconds"]
            t = time.perf_counter()
            out["a_crash"] = repl_crash(
                root, scratch, per_key, nxt["pair"], spawned,
                after_load=lambda: nxt.setdefault(
                    "owners", (cluster_owners_spawn(root_b, scratch, spawned), time.perf_counter())
                ),
            )
            out["a_crash"]["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            out["b"] = cluster_phase(root_b, scratch, *nxt["owners"])
            out["b"]["seconds"] = time.perf_counter() - t
        finally:
            for proc in spawned:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    out["seconds"] = time.perf_counter() - t0
    return out


# the federation phase (15): quota federation and the live fault injector
# at the default deployment with the dispatch loop (the dispatch.launch
# site fires there)
FED_LIMIT = 50  # each shared key's rule: a fixed window per hour
FED_KEYS_EACH = 8  # shared keys homed at each cluster
FED_BURST = 8  # calls on a key a round of the outage
FED_ROUNDS = 13  # the outage's rounds: every fully driven key crosses its limit
FED_PARTIAL_ROUNDS = 4  # half the east-homed keys join for the last rounds only, keeping unspent shares
FED_SETTLE_MS = 50  # FED_SETTLE_INTERVAL_MS of both clusters
FED_PUMP_WAIT_S = 0.2  # between rounds: four settle intervals
# FED_SHARE_TTL_MS of both clusters: longer than any grant's last renewal
# in the outage is from west's stop, so none lapses (and fences west) before
FED_TTL_MS = 20_000
FED_CALLS = 1024  # (a)'s stream of phase 9's v3 calls
FED_RULES = f"""\
domain: fed
descriptors:
  - key: shared
    rate_limit: {{unit: hour, requests_per_unit: {FED_LIMIT}}}
"""


def fed_keys() -> tuple[list, list]:
    """The shared descriptor values: FED_KEYS_EACH homed at east (even
    fingerprints: the members sort east, west) and as many at west."""
    from api_ratelimit_tpu_torch.models import Descriptor
    from api_ratelimit_tpu_torch.ops.hashing import fingerprint64

    homed = {0: [], 1: []}
    i = 0
    while min(len(v) for v in homed.values()) < FED_KEYS_EACH:
        fp = fingerprint64("fed", Descriptor.of(("shared", f"s{i}")).entries, 3600)
        if len(homed[fp % 2]) < FED_KEYS_EACH:
            homed[fp % 2].append(f"s{i}")
        i += 1
    return homed[0], homed[1]


def fed_call(caller, value: str) -> int:
    """One v3 call on a shared key: its overall code (an RPC error fails the
    phase: every call must be answered)."""
    from api_ratelimit_tpu_torch.pb import rls_v3

    req = rls_v3.RateLimitRequest(domain="fed")
    req.descriptors.add().entries.add(key="shared", value=value)
    return rls_v3.RateLimitResponse.FromString(caller(req, timeout=60)).overall_code


def fed_doc(port: int, path: str) -> dict:
    status, body = http_call(port, "GET", path)
    check(status == 200, f"GET {path} on {port} answered {status}")
    return json.loads(body)


def fed_east_owner(root: str, scratch: str, env: dict):
    """East: a sidecar_cmd owner child on the card. Returns (its sidecar
    address, its debug port, a stop function that SIGTERMs it and checks
    its exit 0)."""
    proc, _env, debug = owner_spawn(root, scratch, "fed_east", **env)
    owners_wait([(proc, _env, debug)], "the federation's east owner")
    return _env["SIDECAR_SOCKET"], debug, lambda: stop_procs([proc], "the federation's east owner")


def fed_outage(west, caller, east_debug: int, east_keys: list, west_keys: list) -> dict:
    """(b): the card's launches failed through POST /debug/faults; rounds of
    FED_BURST sequential calls on each shared key, FED_PUMP_WAIT_S apart.
    Returns each key's codes and the checks' figures."""
    from api_ratelimit_tpu_torch.pb import rls_v3

    ok = rls_v3.RateLimitResponse.OK
    full, partial = east_keys[: FED_KEYS_EACH // 2], east_keys[FED_KEYS_EACH // 2 :]
    status, body = http_call(west.server.debug_port, "POST", "/debug/faults", b"dispatch.launch:error:1")
    check(status == 200, f"(b) POST /debug/faults answered {status}: {body!r}")
    t_start = time.time()
    snap0 = west.stats_store.debug_snapshot()
    hits0 = west.federation.fallback_hits_total
    codes = {v: [] for v in east_keys + west_keys}
    for r in range(FED_ROUNDS):
        for value in full + west_keys + (partial if r >= FED_ROUNDS - FED_PARTIAL_ROUNDS else []):
            for _ in range(FED_BURST):
                codes[value].append(fed_call(caller, value))
        time.sleep(FED_PUMP_WAIT_S)
    calls = sum(len(c) for c in codes.values())
    oks = {v: sum(c == ok for c in cs) for v, cs in codes.items()}
    for value in east_keys + west_keys:
        check(oks[value] <= FED_LIMIT, f"(b) shared key {value} admitted {oks[value]}, over its limit {FED_LIMIT}")
    for value in west_keys:
        # the home budget: the first FED_LIMIT calls, then the rung
        check(codes[value] == [ok] * FED_LIMIT + [codes[value][-1]] * (len(codes[value]) - FED_LIMIT)
              and codes[value][-1] != ok, f"(b) west-homed {value}: {codes[value]}")
    for value in east_keys:
        # no share yet: the first call is refused and asks east for one; the
        # pump brings the grant (its thread runs every FED_SETTLE_MS)
        check(oks[value] > 0 and codes[value][0] != ok,
              f"(b) east-homed {value} was not refused until a grant came: {codes[value][:2 * FED_BURST]}")
    for value in full:
        check(oks[value] == FED_LIMIT, f"(b) east-homed {value} admitted {oks[value]} of {len(codes[value])}, not {FED_LIMIT}")
    snap = west.stats_store.debug_snapshot()
    deny = snap["ratelimit.fallback.deny"] - snap0.get("ratelimit.fallback.deny", 0)
    fed_hits = west.federation.fallback_hits_total - hits0
    check(deny == calls, f"(b) the ladder took {deny} of {calls} calls")
    check(fed_hits == sum(oks.values()), f"(b) the share rung served {fed_hits}, the OK answers were {sum(oks.values())}")
    # every share-served answer's journey carries the fed flag, and no other
    journeys = fed_doc(west.server.debug_port, "/debug/journeys")["retained"]
    outage = [j for j in journeys if j["wall_start"] >= t_start]
    flagged = sum("fed" in j["flags"] for j in outage)
    check(flagged == fed_hits, f"(b) {flagged} retained journeys carry the fed flag, the rung served {fed_hits}")
    faults = fed_doc(west.server.debug_port, "/debug/faults")
    rule = faults["rules"][0]
    check(rule["spec"] == "dispatch.launch:error:1" and rule["fires"] == calls == faults["fired"]["dispatch.launch:error"],
          f"(b) /debug/faults: {faults}")
    time.sleep(FED_PUMP_WAIT_S)  # the last round's settles
    west_doc = fed_doc(west.server.debug_port, "/debug/federation")
    east_doc = fed_doc(east_debug, "/debug/federation")
    check(west_doc["shares_held"] == len(east_keys), f"(b) west holds {west_doc['shares_held']} shares")
    check(east_doc["grants_total"] >= len(east_keys) and east_doc["settles_total"] > 0,
          f"(b) east's ledger: {east_doc}")
    rows = west.federation.export_rows()
    from api_ratelimit_tpu_torch.persist.snapshot import FED_COL_GRANTED, FED_COL_SETTLED, FED_COL_SPENT

    shares = rows[rows[:, FED_COL_GRANTED] > 0]
    check(bool(np.all(shares[:, FED_COL_GRANTED] <= FED_LIMIT)) and bool(np.all(shares[:, FED_COL_SPENT] <= shares[:, FED_COL_GRANTED])),
          f"(b) a share past its limit: {shares.tolist()}")
    unsettled = int(np.sum(shares[:, FED_COL_GRANTED].astype(np.int64) - shares[:, FED_COL_SETTLED]))
    check(east_doc["shares_outstanding"] == unsettled,
          f"(b) east counts {east_doc['shares_outstanding']} tokens out, west holds {unsettled} unsettled")
    return {
        "calls": calls, "ok": sum(oks.values()), "over": calls - sum(oks.values()),
        "ok_per_key": {"east_full": [oks[v] for v in full], "east_partial": [oks[v] for v in partial],
                       "west": [oks[v] for v in west_keys]},
        "first_ok_call": {v: codes[v].index(ok) for v in east_keys},
        "seconds_per_call": (time.time() - t_start - FED_ROUNDS * FED_PUMP_WAIT_S) / calls,
        "fallback_deny": deny, "fed_served": fed_hits, "journeys_fed": flagged, "launch_fires": rule["fires"],
        "west": {k: west_doc[k] for k in ("shares_held", "share_tokens", "resyncs_total", "exchange_errors_total")},
        "east": {k: east_doc[k] for k in ("grants_total", "grant_tokens_total", "settles_total", "shares_outstanding")},
        "seconds": time.time() - t_start,
    }


def fed_exchange_faults(west, east_addr: str, east_debug: int) -> dict:
    """(c): fed.exchange corrupt once on west (POST /debug/faults, the
    outage's rule kept) and fed.apply drop once on east (OP_FAULTS_SET).
    The exhausted keys' wants keep west's pump exchanging; each fault fires
    once, the link drops and resyncs, and no share grows past its limit."""
    from api_ratelimit_tpu_torch.backends.sidecar import admin_set_faults
    from api_ratelimit_tpu_torch.persist.snapshot import FED_COL_GRANTED

    t0 = time.time()
    fed = west.federation
    resyncs0, errors0 = fed.resyncs_total, fed.exchange_errors_total
    spec = "dispatch.launch:error:1,fed.exchange:corrupt:1:times=1"
    status, body = http_call(west.server.debug_port, "POST", "/debug/faults", spec.encode())
    check(status == 200, f"(c) POST /debug/faults answered {status}: {body!r}")
    east_set = admin_set_faults(east_addr, "fed.apply:drop:1:times=1")
    check([r["spec"] for r in east_set["rules"]] == ["fed.apply:drop:1:times=1"], f"(c) OP_FAULTS_SET answered {east_set}")

    def fired() -> tuple[int, int]:
        east_fired = fed_doc(east_debug, "/debug/faults")["fired"].get("fed.apply:drop", 0)
        return west.fault_injector.fired().get("fed.exchange:corrupt", 0), east_fired

    wait_until(lambda: fired() == (1, 1) and fed.resyncs_total >= resyncs0 + 2
               and fed.describe()["peers"]["east"]["connected"], "(c) both exchange faults and the resyncs", timeout=30.0)
    time.sleep(5 * FED_SETTLE_MS / 1e3)
    check(fired() == (1, 1), f"(c) the faults fired {fired()} times, not once each")
    rows = fed.export_rows()
    check(bool(np.all(rows[:, FED_COL_GRANTED] <= FED_LIMIT)), f"(c) a share past its limit: {rows.tolist()}")
    return {
        "fired": {"west fed.exchange:corrupt": 1, "east fed.apply:drop": 1},
        "resyncs": fed.resyncs_total - resyncs0, "exchange_errors": fed.exchange_errors_total - errors0,
        "seconds": time.time() - t0,
    }


def fed_restart(west_env: dict, west, clock, east_debug: int, east_keys: list, west_keys: list, device: str) -> dict:
    """(e): west stops (slab.snap and fed.snap); past the TTL east reclaims
    exactly west's unsettled shares; a fresh west restores the live rows,
    floors the slab at the home counts before the upload, and its first
    exchange is the handshake snapshot."""
    import grpc

    from api_ratelimit_tpu_torch.persist.snapshot import (
        COL_COUNT, COL_FP_HI, COL_FP_LO, COL_WINDOW, FED_COL_EXPIRE, FED_COL_FP_HI, FED_COL_FP_LO,
        FED_COL_GRANTED, FED_COL_OUT, FED_COL_SETTLED, FED_COL_SPENT, FED_COL_WINDOW, FLAG_FED, load_snapshot,
    )
    from api_ratelimit_tpu_torch.persist.snapshotter import fed_snapshot_path, snapshot_paths
    from api_ratelimit_tpu_torch.pb import rls_v3

    east0 = fed_doc(east_debug, "/debug/federation")
    check(east0["reclaims_total"] == 0 and not any(east0["fences"].values()),
          f"(e) east reclaimed or fenced before west stopped: {east0}")
    t_stop = time.time()
    west.stop()
    snap_dir = west_env["SLAB_SNAPSHOT_DIR"]
    check(all(os.path.exists(p) for p in snapshot_paths(snap_dir, 1)), "(e) no slab.snap after the drain")
    header, rows = load_snapshot(fed_snapshot_path(snap_dir))
    check(header.flags == FLAG_FED, f"(e) fed.snap carries flags {header.flags}")
    rows = np.asarray(rows, dtype=np.uint32)
    shares = rows[rows[:, FED_COL_GRANTED] > 0]
    expected = int(np.sum(shares[:, FED_COL_GRANTED].astype(np.int64) - shares[:, FED_COL_SETTLED]))
    check(shares.shape[0] == len(east_keys) and expected > 0,
          f"(e) fed.snap holds {shares.shape[0]} share rows, {expected} unsettled tokens")
    check(east0["shares_outstanding"] == expected, f"(e) east counts {east0['shares_outstanding']} out, fed.snap {expected}")

    def reclaimed() -> int:
        return fed_doc(east_debug, "/debug/federation")["reclaimed_tokens_total"] - east0["reclaimed_tokens_total"]

    wait_until(lambda: reclaimed() >= expected and fed_doc(east_debug, "/debug/federation")["reclaims_total"] >= len(east_keys),
               "(e) east's reclaim of west's shares", timeout=FED_TTL_MS / 1e3 + 15.0)
    east1 = fed_doc(east_debug, "/debug/federation")
    check(reclaimed() == expected and east1["reclaims_total"] == len(east_keys),
          f"(e) east reclaimed {reclaimed()} tokens in {east1['reclaims_total']} grants, fed.snap holds {expected} in {len(east_keys)}")
    reclaim_s = time.time() - t_stop
    # west's clock passes the TTL while it is down, as east's did
    clock.advance(int(math.ceil(max(reclaim_s, FED_TTL_MS / 1e3))) + 1)
    now = int(clock.unix_now())
    settled = (rows[:, FED_COL_GRANTED] <= rows[:, FED_COL_SPENT]) & (rows[:, FED_COL_SETTLED] >= rows[:, FED_COL_SPENT]) & (rows[:, FED_COL_OUT] == 0)
    live = rows[(rows[:, FED_COL_EXPIRE].astype(np.int64) > now) & ~settled]
    west2, boot_s = process_boot(west_env, device=device)
    try:
        stats = west2.snapshotter.restore_stats
        gauge = west2.stats_store.debug_snapshot().get("ratelimit.snapshot.restore_fed_shares")
        check(stats["restored_fed_shares"] == live.shape[0] == len(west_keys) and gauge == live.shape[0],
              f"(e) restore_fed_shares {stats['restored_fed_shares']} (gauge {gauge}), live rows {live.shape[0]}")
        table = west2.cache.engine.export_tables()[0]
        matched = []
        for row in live:
            hit = np.flatnonzero((table[:, COL_FP_LO] == row[FED_COL_FP_LO]) & (table[:, COL_FP_HI] == row[FED_COL_FP_HI])
                                 & (table[:, COL_WINDOW] == row[FED_COL_WINDOW]))
            for idx in hit:
                matched.append((int(table[idx, COL_COUNT]), int(row[FED_COL_SPENT])))
        check(len(matched) == len(west_keys) and all(count >= floor for count, floor in matched),
              f"(e) the restored slab against the share floors (count, floor): {matched}")
        # the first exchange after the reboot: the card's launches failed
        # again, a borrowed key asks for a share on its miss
        fed2 = west2.federation
        status, _ = http_call(west2.server.debug_port, "POST", "/debug/faults", b"dispatch.launch:error:1")
        check(status == 200, f"(e) POST /debug/faults answered {status}")
        probe = east_keys[-1]
        with grpc.insecure_channel(f"localhost:{west2.server.grpc_port}") as ch:
            call = raw_caller(ch, V3_PATH)
            first = fed_call(call, probe)
            wait_until(lambda: fed2.share_balance() > 0, "(e) west's first grant after the reboot", timeout=15.0)
            second = fed_call(call, probe)
        doc = fed2.describe()
        east2 = fed_doc(east_debug, "/debug/federation")
        check(first == rls_v3.RateLimitResponse.OVER_LIMIT and second == rls_v3.RateLimitResponse.OK,
              f"(e) the probe answered {first} then {second}")
        check(doc["resyncs_total"] == 1 and doc["exchange_errors_total"] == 0 and doc["peers"]["east"]["fence_epoch"] >= 1
              and east2["stale_epoch_rejected_total"] == east1["stale_epoch_rejected_total"],
              f"(e) west's first exchange was not the handshake snapshot: {doc}, east {east2}")
        http_call(west2.server.debug_port, "POST", "/debug/faults", b"")
    finally:
        west2.stop()
    return {
        "fed_snap_rows": int(rows.shape[0]), "share_rows": int(shares.shape[0]), "unsettled_tokens": expected,
        "east_reclaims": east1["reclaims_total"], "east_reclaimed_tokens": reclaimed(), "stop_to_reclaim_s": reclaim_s,
        "restore_fed_shares": stats["restored_fed_shares"], "dropped_fed_shares": stats["dropped_fed_shares"],
        "floored_rows": matched, "boot_s": boot_s, "fence_epoch_adopted": doc["peers"]["east"]["fence_epoch"],
        "first_exchange": "handshake snapshot (resyncs 1, errors 0, no stale settle at east)",
    }


def phase_federation(K, device: str = "cuda", east=fed_east_owner, **overrides) -> dict:
    """Phase 15 (module docstring). `east(root, scratch, env)` boots the
    east cluster and returns (its address, its debug port, a stop
    function); `overrides`: environment variables for both clusters (a
    small slab on the CPU)."""
    import tempfile

    import grpc

    from api_ratelimit_tpu_torch.backends.sidecar import admin_set_faults
    from api_ratelimit_tpu_torch.pb import rls_v3
    from api_ratelimit_tpu_torch.utils import FakeTimeSource, RealTimeSource, install_process_time_source

    t_phase = time.perf_counter()
    out = {}
    east_keys, west_keys = fed_keys()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fed_") as scratch:
        root = os.path.join(scratch, "runtime")
        config = process_runtime(root)
        write_text(os.path.join(config, "fed.yaml"), FED_RULES)
        east_addr = os.path.join(scratch, "fed_east.sock")
        # west is a Runner in this process: it serves no sidecar listener,
        # and nothing dials its entry (east borrows nothing here)
        peers = f"east={east_addr},west={os.path.join(scratch, 'fed_west.sock')}"
        fed_env = {"FED_ENABLED": "true", "FED_PEERS": peers, "FED_SETTLE_INTERVAL_MS": str(FED_SETTLE_MS),
                   "FED_SHARE_TTL_MS": str(FED_TTL_MS)}
        t = time.perf_counter()
        east_addr, east_debug, stop_east = east(root, scratch, {**fed_env, "FED_SELF": "east", **overrides})
        out["east_boot_s"] = time.perf_counter() - t
        # one fake clock for west and its rollback twin, early in an hour so
        # the phase's windows never roll (east runs on the real clock)
        clock = FakeTimeSource(int(time.time()) // 3600 * 3600 + 60)
        install_process_time_source(clock)
        runners = []
        try:
            base = dict(TPU_BATCH_WINDOW="200us", FAILURE_MODE_DENY="deny", JOURNEY_RETAIN="8192", **overrides)
            control, _ = process_boot(process_env(root, "cuda", **base), device=device)
            runners.append(control)
            west_env = process_env(root, "cuda", **base, **fed_env, FED_SELF="west",
                                   SLAB_SNAPSHOT_DIR=os.path.join(scratch, "west_snap"),
                                   SLAB_SNAPSHOT_INTERVAL_MS=str(WARM_SNAPSHOT_MS))
            west, boot_s = process_boot(west_env, device=device)
            runners.append(west)
            out["west_boot_s"] = boot_s
            # (a) the rollback arm, card healthy: byte-identical to FED_ENABLED=false
            t = time.perf_counter()
            rng = np.random.default_rng(7)
            reqs = process_requests(rng, FED_CALLS, PROCESS_KEYS)
            for k in K.LAUNCHES:
                K.LAUNCHES[k] = 0
            west_launches = collections.Counter()
            with grpc.insecure_channel(f"localhost:{west.server.grpc_port}") as wc, grpc.insecure_channel(
                f"localhost:{control.server.grpc_port}"
            ) as cc:
                w_call, c_call = raw_caller(wc, V3_PATH), raw_caller(cc, V3_PATH)
                for i, req in enumerate(reqs):
                    if i and i % PROCESS_CLOCK_EVERY == 0:
                        clock.advance(int(rng.choice([1, 7, 61])))
                    before = served_launches(K)
                    got = w_call(req, timeout=60)
                    west_launches.update({k: v - before[k] for k, v in served_launches(K).items()})
                    want = c_call(req, timeout=60)
                    check(got == want, f"(a) call {i}: the federated cluster's answer differs from the rollback arm's")
            if device == "cuda":
                for kernel in ("way_scan", "slab_apply", "sketch_update"):
                    check(west_launches[kernel] == FED_CALLS, f"(a) west launched {kernel} {west_launches[kernel]} times in {FED_CALLS} calls")
            families = sorted({k.split("{")[0] for k in metrics_of(west.server.debug_port) if k.startswith("ratelimit_fed_")})
            check(len(families) >= 8, f"(a) /metrics carries the fed families {families}")
            counters = obs_counters(west)
            check(not any(counters.values()), f"(a) the ladder answered with the card healthy: {counters}")
            out["a"] = {"calls": FED_CALLS, "west_launches": dict(west_launches), "fed_families": families,
                        "fallback": counters, "seconds": time.perf_counter() - t}
            log(f"federation (a): east up in {out['east_boot_s']:.1f} s, {FED_CALLS} calls alike in {out['a']['seconds']:.1f} s")
            control.stop()
            runners.remove(control)
            with grpc.insecure_channel(f"localhost:{west.server.grpc_port}") as wc:
                caller = raw_caller(wc, V3_PATH)
                # (b) the card's outage through the live injector
                launches0 = served_launches(K)
                out["b"] = fed_outage(west, caller, east_debug, east_keys, west_keys)
                log(f"federation (b): {out['b']['calls']} calls in {out['b']['seconds']:.1f} s, {out['b']['ok']} admitted")
                launched = {k: v - launches0[k] for k, v in served_launches(K).items()}
                check(not any(launched.values()), f"(b) the card launched during the outage: {launched}")
                # (c) exchange faults at both ends
                out["c"] = fed_exchange_faults(west, east_addr, east_debug)
                log(f"federation (c): {out['c']['resyncs']} resyncs in {out['c']['seconds']:.1f} s")
                # (d) recovery: the empty spec at both, the card answers again
                t = time.perf_counter()
                check(http_call(west.server.debug_port, "POST", "/debug/faults", b"")[0] == 200, "(d) clearing west's faults")
                check(admin_set_faults(east_addr, "")["rules"] == [], "(d) clearing east's faults")
                snap0, hits0, launches0 = west.stats_store.debug_snapshot(), west.federation.fallback_hits_total, served_launches(K)
                codes = [fed_call(caller, v) for v in east_keys + west_keys]
                snap = west.stats_store.debug_snapshot()
                launched = {k: v - launches0[k] for k, v in served_launches(K).items()}
                check(all(c == rls_v3.RateLimitResponse.OK for c in codes), f"(d) the card's answers: {codes}")
                check(snap["ratelimit.fallback.deny"] == snap0["ratelimit.fallback.deny"]
                      and west.federation.fallback_hits_total == hits0, "(d) the ladder answered after the recovery")
                if device == "cuda":
                    check(all(v == len(codes) for v in launched.values()), f"(d) launches after the recovery: {launched}")
                out["d"] = {"calls": len(codes), "launches": launched, "seconds": time.perf_counter() - t}
            # (e) restart and reclaim
            t = time.perf_counter()
            runners.remove(west)
            out["e"] = fed_restart(west_env, west, clock, east_debug, east_keys, west_keys, device)
            out["e"]["seconds"] = time.perf_counter() - t
        finally:
            for r in runners:
                r.stop()
            install_process_time_source(RealTimeSource())
            stop_east()
    out["seconds"] = time.perf_counter() - t_phase
    b, e = out["b"], out["e"]
    log(
        f"federation: outage {b['calls']} calls, {b['ok']} admitted ({b['fed_served']} by the share rung, "
        f"{b['journeys_fed']} fed journeys), exchange faults resynced {out['c']['resyncs']} times, east reclaimed "
        f"{e['east_reclaimed_tokens']} tokens = fed.snap's unsettled, {e['restore_fed_shares']} rows restored "
        f"({out['seconds']:.1f} s)"
    )
    return out


def codec_packages() -> dict:
    """Whether grpc, google.protobuf and yaml import here, with their
    versions (None where they do not): the settings/runner slice chooses its
    wire codec by them. Printed only; nothing depends on it."""
    import importlib

    out = {}
    for name in ("grpc", "google.protobuf", "yaml"):
        try:
            mod = importlib.import_module(name)
        except Exception as e:  # noqa: BLE001 (absence is the answer)
            out[name] = {"present": False, "error": f"{type(e).__name__}: {e}"[:120]}
        else:
            out[name] = {"present": True, "version": getattr(mod, "__version__", None)}
    return out


# -- phase 16: the chaos campaign engine and the operator tools ---------------

CHAOS_SEEDS = (1, 2, 3, 4)  # at the default CampaignConfig (120 steps, every class)
CHAOS_WEAKEN_SEED = 3
# the checker's self-test config (tools/chaos_campaign.py --weaken): kills
# only, one over-offered key, no eviction or federation slack
CHAOS_KILL_ONLY = dict(
    steps=40, classes=("process_kill",), tracked_keys=1, lease_offers=8, fillers=0,
    fillers_per_step=0, fed_offers=0, snapshot_every=0, victim_every=0,
)
HOTPATH_N = 200  # requests of the default arm, under the thread profiler
HOTPATH_DISPATCH_N = 400
TOOL_TIMEOUT_S = 300.0
HOTPATH = "api_ratelimit_tpu_torch.tools.hotpath_profile"


def chaos_campaigns(K, device: str = "cuda") -> dict:
    """(a) The campaigns: each seed at the default config on the CPU, then
    on `device`, the card (every launch counter set to 0 just before), each
    ok and byte-identical to its CPU run; replay_matches on the card; the
    weakened crash term caught, blamed and shrunk on the card."""
    import logging

    from api_ratelimit_tpu_torch.chaos import campaign as C
    from api_ratelimit_tpu_torch.chaos import nemesis as N
    from api_ratelimit_tpu_torch.chaos import shrink as SH

    logging.disable(logging.CRITICAL)  # the nemesis's injected faults log by design
    try:
        cpu, cpu_s = {}, {}
        for seed in CHAOS_SEEDS:
            t0 = time.perf_counter()
            cpu[seed] = N.canonical_json(C.run_campaign(seed, device="cpu"))
            cpu_s[seed] = time.perf_counter() - t0
        K.reset_launch_counts()
        card, card_s, verdicts = {}, {}, {}
        for seed in CHAOS_SEEDS:
            t0 = time.perf_counter()
            doc = C.run_campaign(seed, device=device)
            card_s[seed] = time.perf_counter() - t0
            card[seed] = N.canonical_json(doc)
            verdicts[seed] = doc["verdict"]
        launches = {k: K.LAUNCHES[k] for k in ("way_scan", "slab_apply", "sketch_update")}
        forms = {"way_scan": dict(K.WAY_SCAN_FORMS), "way_scan_multi": dict(K.WAY_SCAN_MULTI_FORMS)}
        for seed in CHAOS_SEEDS:
            check(verdicts[seed] == "ok", f"seed {seed} on the card: verdict {verdicts[seed]}")
            check(card[seed] == cpu[seed], f"seed {seed}: the card's canonical JSON differs from the CPU's")
        if device == "cuda":
            check(forms["way_scan"]["per_item"] > 0, f"the campaigns launched no way_scan_kernel<false>: {forms}")
            check(launches["slab_apply"] > 0, f"the campaigns launched no slab_apply_kernel: {launches}")
            check(forms["way_scan_multi"]["per_item"] > 0, f"the campaigns' promotes launched no multi way scan: {forms}")
            check(launches["sketch_update"] == 0, f"the campaigns (hotkey_lanes 0) launched the sketch update: {launches}")
        replay = {}
        for seed in CHAOS_SEEDS:
            replay[seed] = C.replay_matches(seed, device=device)
            check(replay[seed], f"seed {seed}: two runs on the card gave different canonical JSON")
        cfg = C.CampaignConfig(**CHAOS_KILL_ONLY)
        timeline = N.draw_timeline(CHAOS_WEAKEN_SEED, cfg.steps, cfg.classes, cfg.nemesis_rate)
        full = C.run_campaign(CHAOS_WEAKEN_SEED, config=cfg, timeline=timeline, device=device)
        check(full["verdict"] == "ok", f"the full bound flagged the kill timeline: {full['violations']}")
        weak = C.run_campaign(CHAOS_WEAKEN_SEED, config=cfg, timeline=timeline, weaken="crash", device=device)
        check(weak["verdict"] == "violation", "the weakened crash term was not caught")
        check(all(v["blame"] == ["crash"] for v in weak["violations"]), f"the violations blame {weak['violations']}")
        t0 = time.perf_counter()
        minimal = SH.shrink_timeline(CHAOS_WEAKEN_SEED, timeline, config=cfg, weaken="crash", device=device)
        shrink_s = time.perf_counter() - t0
        check(1 <= len(minimal) <= 3, f"ddmin left {len(minimal)} actions")
        check(any(a["cls"] == "process_kill" and a["role"] == "owner" for a in minimal), f"the repro holds no owner kill: {minimal}")
    finally:
        logging.disable(logging.NOTSET)
    return {
        "seeds": list(CHAOS_SEEDS),
        "verdicts": verdicts,
        "identical_to_cpu": True,
        "replay_matches": replay,
        "timeline_crc": {seed: json.loads(card[seed])["timeline_crc"] for seed in CHAOS_SEEDS},
        "admits": {seed: sum(json.loads(card[seed])["ledger"]["admits"].values()) for seed in CHAOS_SEEDS},
        "evict_lost": {seed: json.loads(card[seed])["ledger"]["evict_lost"] for seed in CHAOS_SEEDS},
        "card_s": card_s,
        "cpu_s": cpu_s,
        "launches": launches,
        "way_scan_forms": forms,
        "weakened": {"seed": CHAOS_WEAKEN_SEED, "actions": len(timeline), "violations": len(weak["violations"]),
                     "blame": sorted({b for v in weak["violations"] for b in v["blame"]}), "minimal": minimal,
                     "shrink_s": shrink_s},
    }


def tool_run(module: str, args: list, label: str):
    """One tool as a process: exit 0, its stdout lines."""
    t0 = time.perf_counter()
    proc = run_module(module, args, dict(os.environ), timeout=TOOL_TIMEOUT_S)
    check(proc.returncode == 0, f"{label} exited {proc.returncode}: {proc.stderr[-1500:]}")
    return proc.stdout.splitlines(), time.perf_counter() - t0


def hotpath_line(lines: list, label: str, device: str) -> dict:
    summary = [ln for ln in lines if ln.startswith("[hotpath] rate=")]
    check(summary, f"{label}: no [hotpath] line")
    fields = dict(f.split("=", 1) for f in summary[0].split()[1:])
    check(int(fields["rate"][: -len("/s")]) > 0, f"{label}: {summary[0]}")
    check(fields.get("device", "").startswith(device), f"{label} did not run on {device}: {summary[0]}")
    check(any("ncalls" in ln and "tottime" in ln for ln in lines), f"{label}: no pstats table")
    return fields


def slab_split_lines(lines: list, device: str) -> dict:
    """--slab-split's rows and its /metrics exposition: batch 8192 at the
    served width, 30 samples a stage, each p50 in the bucket the
    exposition's cumulative counts put half the samples in."""
    head = [ln for ln in lines if ln.startswith("[slab_split] batch=")]
    check(head and int(head[0].split("batch=")[1]) == 8192, f"slab split: {head}")
    geo = [ln for ln in lines if ln.startswith("[slab_split] ways=")]
    fields = dict(f.split("=", 1) for f in geo[0].split()[1:]) if geo else {}
    ways, rows = (128, N_SLOTS) if device == "cuda" else (4, 1 << 18)  # tools/service_stack.py
    check(fields.get("ways") == str(ways) and fields.get("rows") == str(rows) and fields.get("device", "").startswith(device),
          f"slab split ran at {geo}")
    out = {"batch": 8192, **fields}
    for stage in ("gather", "scan", "scatter"):
        row = [ln for ln in lines if ln.strip().startswith(f"{stage}_ns")]
        check(row, f"slab split: no {stage}_ns row")
        p50 = int(row[0].split("p50=")[1].split()[0])
        p99 = int(row[0].split("p99=")[1].split()[0])
        count = [ln for ln in lines if ln.startswith(f"ratelimit_slab_split_{stage}_ms_count")]
        check(count and float(count[0].split()[-1]) == 30, f"/metrics counts {count} {stage} samples, not 30")
        buckets = [
            (float(ln.split('le="')[1].split('"')[0]), float(ln.split()[-1]))
            for ln in lines if ln.startswith(f"ratelimit_slab_split_{stage}_ms_bucket") and "+Inf" not in ln
        ]
        above = [n for le, n in buckets if le >= p50 / 1e6]
        below = [n for le, n in buckets if le < p50 / 1e6]
        check((not above or above[0] >= 15) and (not below or below[-1] <= 15),
              f"the {stage} row's p50 {p50} ns disagrees with /metrics' buckets {buckets}")
        out[f"{stage}_ns"] = {"p50": p50, "p99": p99}
    return out


def chaos_tools(kept: dict, device: str = "cuda") -> dict:
    """(b) The tools as processes on the card: hotpath_profile's default
    and --dispatch arms, --slab-split at the served width with its
    /metrics histograms agreeing, and snapshot_inspect on phase 11's
    slab.snap, its restorable rows the rows phase 11 restored."""
    out = {}
    dev = ["--device", device]
    lines, secs = tool_run(HOTPATH, ["-n", str(HOTPATH_N), "--top", "12", *dev], "hotpath_profile")
    out["hotpath"] = hotpath_line(lines, "hotpath_profile", device) | {"process_s": secs}
    check(any("should_rate_limit" in ln for ln in lines), "the request thread's table names no should_rate_limit")
    lines, secs = tool_run(HOTPATH, ["-n", str(HOTPATH_DISPATCH_N), "--top", "12", "--dispatch", *dev], "hotpath_profile --dispatch")
    out["dispatch"] = hotpath_line(lines, "hotpath_profile --dispatch", device) | {"process_s": secs}
    check(out["dispatch"].get("path") == "dispatch-owner", f"--dispatch ran path {out['dispatch']}")
    check(any("dispatch.py" in ln and "(_run)" in ln for ln in lines), "the owner thread's table names no dispatch.py _run")
    check(not any("should_rate_limit" in ln for ln in lines), "the owner thread's table holds the request threads' calls")
    out["dispatch"]["owner_table"] = [ln for ln in lines if "{" not in ln and ("dispatch.py" in ln or "cuda.py" in ln)][:6]
    lines, secs = tool_run(HOTPATH, ["--slab-split", *dev], "hotpath_profile --slab-split")
    out["slab_split"] = slab_split_lines(lines, device) | {"process_s": secs}
    lines, secs = tool_run(
        "api_ratelimit_tpu_torch.tools.snapshot_inspect", ["--json", "--now", str(kept["now"]), kept["path"]],
        "snapshot_inspect",
    )
    report = json.loads("\n".join(lines))[0]
    check(report["valid"], f"snapshot_inspect rejected phase 11's slab.snap: {report}")
    check(report["rows"]["restorable"] == kept["restored"],
          f"snapshot_inspect reads {report['rows']['restorable']} restorable rows, phase 11 restored {kept['restored']}")
    out["snapshot_inspect"] = {"restorable": report["rows"]["restorable"], "occupied": report["rows"]["occupied"],
                               "restored_in_phase_11": kept["restored"], "bytes": report["bytes"], "process_s": secs}
    return out


def phase_chaos(K, kept: dict, device: str = "cuda") -> dict:
    """Phase 16 (module docstring)."""
    t0 = time.perf_counter()
    campaigns = chaos_campaigns(K, device)
    t_campaigns = time.perf_counter() - t0
    tools = chaos_tools(kept, device)
    out = {"campaigns": campaigns, "tools": tools, "campaigns_s": t_campaigns, "phase_s": time.perf_counter() - t0}
    split = tools["slab_split"]
    log(
        f"chaos: seeds {list(CHAOS_SEEDS)} ok and byte-identical to the CPU, {campaigns['launches']} launches,"
        f" card {np.mean(list(campaigns['card_s'].values())):.2f} s / CPU {np.mean(list(campaigns['cpu_s'].values())):.2f} s"
        f" a campaign; crash weakened: {campaigns['weakened']['violations']} violations shrunk to"
        f" {len(campaigns['weakened']['minimal'])} action(s); hotpath {tools['hotpath']['rate']},"
        f" dispatch {tools['dispatch']['rate']}; slab split gather/scan/scatter p50"
        f" {split['gather_ns']['p50']}/{split['scan_ns']['p50']}/{split['scatter_ns']['p50']} ns;"
        f" snapshot_inspect {tools['snapshot_inspect']['restorable']} rows ({out['phase_s']:.1f} s)"
    )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from api_ratelimit_tpu_torch import utils
    from api_ratelimit_tpu_torch.backends import cuda as cuda_mod
    from api_ratelimit_tpu_torch.ops import decide as D
    from api_ratelimit_tpu_torch.ops import sketch as SKT
    from api_ratelimit_tpu_torch.ops import sketch_kernels as SKK
    from api_ratelimit_tpu_torch.ops import slab as S
    from api_ratelimit_tpu_torch.ops import slab_kernels as K
    from api_ratelimit_tpu_torch.ops import select_kernels as SEL
    from api_ratelimit_tpu_torch.testing import oracle as O
    from api_ratelimit_tpu_torch.tools import microbench_compare_paths as CMP

    M = types.SimpleNamespace(
        K=K, S=S, SKK=SKK, SKT=SKT, D=D, O=O, SEL=SEL, CMP=CMP, cuda_mod=cuda_mod, utils=utils
    )
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    log("wire codec packages:", json.dumps(codec_packages()))
    t0 = time.perf_counter()
    K.build()
    srcs = [os.path.basename(p) for p in K.sources()]
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {K.BUILD_LOG.get('seconds', 0.0):.1f} s) from {srcs}")
    log(K.BUILD_LOG.get("ptxas", "").strip())
    ptxas = K.BUILD_LOG.get("ptxas", "")
    log("apply kernel ptxas:", json.dumps(ptxas_entries(ptxas, "slab_apply_kernel")))
    scan_ptxas = ptxas_entries(ptxas, "way_scan") + [e for e in ptxas_entries(ptxas, "set_") if "way_scan" not in e]
    log("way scan kernels ptxas:", json.dumps(scan_ptxas))
    # the multi-algorithm instantiations carry the bool template argument
    # true in their mangled names (Lb1E)
    log("way scan kernels ptxas, multi-algorithm:", json.dumps([e for e in scan_ptxas if "Lb1E" in e.split(" | ")[0]]))

    errs = phase_parity(M, dev)
    engine = phase_engine(M, dev)
    launches = phase_serve(K)
    _decided, decided_launches, decided_scan = phase_decided(M, dev, errs)
    select_errs, select_launches = phase_compare_paths(M, dev)
    phase_windowed(M, dev)
    algo = phase_algorithms(M, dev)
    kernels, standalone = kernel_report(
        M, engine, decided_scan, dev, launches | decided_launches | select_launches,
        errs | select_errs | algo["errs"], algo,
    )
    process = phase_process(K)
    observability = phase_observability(K)
    warm = phase_warm_restart(M, K, keep_snapshot=True)
    tiers, promote_row = phase_tiers(M, K)
    kernels.append(promote_row)
    fleet = phase_fleet(K)
    cluster = phase_cluster(fleet["b"]["load"]["requests_per_s"])
    federation = phase_federation(K)
    kept = warm["handoff"].pop("kept")
    try:
        chaos = phase_chaos(K, kept)
    finally:
        os.remove(kept["path"])
        os.rmdir(os.path.dirname(kept["path"]))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log("process:", json.dumps(process | {"card": smi.stdout.strip()}))
    log("observability:", json.dumps(observability))
    log("warm_restart:", json.dumps(warm))
    log("tiers:", json.dumps(tiers))
    log("fleet:", json.dumps(fleet | {"card": smi.stdout.strip()}))
    log("cluster:", json.dumps(cluster | {"card": smi.stdout.strip()}))
    log("federation:", json.dumps(federation | {"card": smi.stdout.strip()}))
    log("chaos:", json.dumps(chaos | {"card": smi.stdout.strip()}))
    log(smi.stdout.strip())
    log("standalone kernels (off every path):", json.dumps({"kernels": standalone}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
