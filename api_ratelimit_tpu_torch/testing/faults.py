"""Port of api_ratelimit_tpu/testing/faults.py: the deterministic
fault-injection harness (FAULT_INJECT).

Chaos testing for the resilience ladder: an env-configurable injector that
the engine, the dispatch loop, the sidecar client and server, the
snapshotter, replication and federation consult at named sites, so tests
(and operators in staging) can rehearse connection drops, latency spikes,
error replies, failed kernel launches and partial writes without real
infrastructure failures. Every failure is deterministic and seedable, and
one spec and seed trip the same calls in both packages: each rule's RNG is
seeded by the same string.

Spec grammar (FAULT_INJECT env var; FAULT_INJECT_SEED seeds the RNG):

    spec  := rule ("," rule)*
    rule  := site ":" kind ":" value qual*
    qual  := ":" ("after" | "times") ("=" | ":") count
    site  := dotted lowercase id (the instrumentation point)
    kind  := error | drop | partial_write
           | queue_full | torn_write
           | corrupt                          value = probability in (0, 1]
           | delay_ms                         value = milliseconds >= 0

e.g. FAULT_INJECT=sidecar.submit:error:0.2,sidecar.submit:delay_ms:500
     FAULT_INJECT=dispatch.launch:error:1.0:after=2:times=1

Qualifiers make faults schedulable: `after=N` arms the rule only once the
site has been hit N times (the first N fire() calls pass clean), and
`times=N` disarms it after it has fired N times, so
`fed.exchange:drop:1.0:after=5:times=1` is a deterministic one-shot that
kills exactly the sixth exchange and nothing else.

delay_ms rules always fire while armed (they model a slow link or a slow
engine, and sum when repeated). Each probabilistic rule draws from its own
seeded RNG stream (seeded by injector seed + site + rule position), so
rules at independent sites compose: adding a rule at site B never shifts
which calls trip at site A, and a rule's draw sequence depends only on its
own site's hit sequence. Within one site, rules are evaluated in spec
order and the first one that trips wins (later rules still consume their
draw, keeping their streams aligned). Junk specs (unknown kinds, bad
values, malformed qualifiers) raise ValueError so a typo'd spec fails the
boot (settings.fault_rules()), like a typo'd bucket ladder.

Sites wired in this package:

    sidecar.dial            client: each dial of the owner's address
    sidecar.submit          client: each SUBMIT attempt (before the send)
    sidecar.server.submit   server: each SUBMIT frame (before the engine)
    batcher.submit          micro-batcher and dispatch loop: each submit
                            before enqueue (one site for both windowed
                            arms); delay_ms stalls the caller, queue_full
                            raises QueueFullError (overload shedding)
    dispatch.launch         dispatch loop (backends/dispatch.py), on the
                            device-owner thread before each launch on the
                            card: delay_ms models a stalled owner, error
                            fails the whole batch's tickets with
                            CacheError so the failure-mode ladder answers
    dispatch.ring_publish   shm submit ring (backends/shm_ring.py), in the
                            frontend process between the arena row copy
                            and the seqno store: delay_ms parks the publish
                            in the torn-frame window, error abandons it
                            with CacheError
    snapshot.write          warm-restart snapshotter: each section file
                            write (persist/snapshot.py): error fails the
                            write, torn_write truncates the payload,
                            corrupt flips payload bytes after the CRC was
                            computed, delay_ms models a slow disk
    snapshot.load           boot restore: each section file load: error
                            rejects outright, corrupt flips bytes before
                            validation; the restore counts
                            snapshot.load_rejected and boots a cold slab
    repl.ship               warm-standby replication, primary side
                            (persist/replication.py): before each frame
                            send: delay_ms (lag), drop (a sequence gap the
                            standby resyncs on), torn_write, error
    repl.apply              warm-standby replication, standby side: before
                            each received frame applies: delay_ms, drop,
                            error/torn_write/corrupt poison the frame and
                            force a resync
    fed.exchange            quota federation, borrower side
                            (cluster/federation.py): before each exchange
                            frame send: delay_ms (settlement lag, the
                            sticky fed.degraded probe), drop (the sequence
                            number consumed unsent), corrupt (a flipped
                            frame byte the home's CRC check rejects),
                            torn_write (half a frame), error (the pump
                            fails); every arm resyncs from the home's
                            ledger snapshot on reconnect
    fed.apply               quota federation, home side: before each
                            received exchange frame applies: delay_ms
                            stalls the grantor, drop loses the frame
                            pre-apply (the borrower times out and
                            resyncs), error/torn_write/corrupt drop the
                            connection, never a suspect grant or settle
    victim.demote           victim tier, demote side (backends/cuda.py
                            _drain_victim): between a launch's demoted
                            row readback and the host insert: drop loses
                            the rows, error counts victim.demote_errors
                            and fails open, delay_ms models a slow table
    victim.promote          victim tier, promote side (backends/cuda.py
                            _inject_promotes_locked): before the pre-step
                            promote pass: drop/error skip it (the rows
                            stay in the tier), delay_ms stalls it

The injector is mutable at runtime (configure()/clear()) so chaos tests
can clear faults mid-scenario. Live processes expose the same mutability
through the `/debug/faults` GET/POST endpoints (server/http_server.py
add_chaos_admin) and the sidecar OP_FAULTS_SET admin op
(backends/sidecar.py), so faults flip on a running process without a
FAULT_INJECT reboot; describe() is the GET body.
"""

from __future__ import annotations

import dataclasses
import random
import re
import threading
import time

FAULT_KINDS = (
    "error",
    "drop",
    "partial_write",
    "queue_full",
    "torn_write",
    "corrupt",
    "delay_ms",
)
_PROB_KINDS = (
    "error",
    "drop",
    "partial_write",
    "queue_full",
    "torn_write",
    "corrupt",
)

_SITE_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")
_QUAL_NAMES = ("after", "times")
_QUAL_EQ_RE = re.compile(r"^(after|times)=(.+)$")

# times == UNLIMITED means "no fire budget" (the pre-qualifier behavior)
UNLIMITED = -1


@dataclasses.dataclass(frozen=True, slots=True)
class FaultRule:
    site: str
    kind: str
    value: float
    after: int = 0
    times: int = UNLIMITED

    def to_spec(self) -> str:
        """Canonical spec chunk for this rule (round-trips via
        parse_fault_spec; the /debug/faults GET body uses it)."""
        out = f"{self.site}:{self.kind}:{self.value:g}"
        if self.after:
            out += f":after={self.after}"
        if self.times != UNLIMITED:
            out += f":times={self.times}"
        return out


def rules_to_spec(rules) -> str:
    return ",".join(r.to_spec() for r in rules)


def _parse_qualifiers(chunk: str, tokens: list[str]) -> dict:
    """Parse trailing rule qualifiers: each is `after=N`/`times=N` or the
    two-token form `after:N`/`times:N`. Anything else is a junk spec."""
    quals: dict = {}

    def _set(name: str, raw: str) -> None:
        if name in quals:
            raise ValueError(
                f"fault rule {chunk!r}: duplicate qualifier {name!r}"
            )
        try:
            count = int(raw)
        except ValueError:
            raise ValueError(
                f"fault rule {chunk!r}: {name} count {raw!r} is not an "
                f"integer"
            ) from None
        if name == "after" and count < 0:
            raise ValueError(f"fault rule {chunk!r}: after must be >= 0")
        if name == "times" and count < 1:
            raise ValueError(f"fault rule {chunk!r}: times must be >= 1")
        quals[name] = count

    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok in _QUAL_NAMES:
            if i + 1 >= len(tokens):
                raise ValueError(
                    f"fault rule {chunk!r}: qualifier {tok!r} needs a count"
                )
            _set(tok, tokens[i + 1])
            i += 2
            continue
        m = _QUAL_EQ_RE.match(tok)
        if m is None:
            raise ValueError(
                f"fault rule {chunk!r}: unknown qualifier {tok!r} "
                f"(expected after=N or times=N)"
            )
        _set(m.group(1), m.group(2))
        i += 1
    return quals


def parse_fault_spec(spec: str) -> list[FaultRule]:
    """Parse a FAULT_INJECT spec; raises ValueError on any malformed rule
    (a junk spec must fail boot, not silently inject nothing)."""
    rules: list[FaultRule] = []
    spec = spec.strip()
    if not spec:
        return rules
    for chunk in spec.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = [p.strip() for p in chunk.split(":")]
        if len(parts) < 3:
            raise ValueError(
                f"fault rule {chunk!r} must be site:kind:value[:after=N]"
                f"[:times=N]"
            )
        site, kind, raw = parts[:3]
        if not _SITE_RE.match(site):
            raise ValueError(
                f"fault rule {chunk!r}: site must be dotted lowercase "
                f"([a-z0-9_] segments joined by '.')"
            )
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"fault rule {chunk!r}: kind must be one of "
                f"{', '.join(FAULT_KINDS)}"
            )
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(
                f"fault rule {chunk!r}: value {raw!r} is not a number"
            ) from None
        if kind in _PROB_KINDS and not 0.0 < value <= 1.0:
            raise ValueError(
                f"fault rule {chunk!r}: {kind} probability must be in (0, 1]"
            )
        if kind == "delay_ms" and value < 0:
            raise ValueError(
                f"fault rule {chunk!r}: delay_ms must be >= 0"
            )
        quals = _parse_qualifiers(chunk, parts[3:])
        rules.append(
            FaultRule(
                site,
                kind,
                value,
                after=quals.get("after", 0),
                times=quals.get("times", UNLIMITED),
            )
        )
    return rules


class _RuleState:
    """Mutable per-rule runtime state: the rule's private RNG stream and
    its fire count (the `times` budget)."""

    __slots__ = ("rule", "rng", "fires")

    def __init__(self, rule: FaultRule, seed: int, index: int):
        self.rule = rule
        # String-seeded Random is deterministic across processes; keying
        # by (seed, site, index, kind) gives every rule its own stream so
        # independent sites compose instead of sharing one draw sequence.
        self.rng = random.Random(
            f"{seed}/{rule.site}/{index}/{rule.kind}/{rule.value!r}"
        )
        self.fires = 0

    def armed(self, site_hits: int) -> bool:
        return site_hits > self.rule.after and (
            self.rule.times == UNLIMITED or self.fires < self.rule.times
        )


class FaultInjector:
    """Evaluates fault rules at named sites. Thread-safe; deterministic for
    a given seed and fire() sequence. fire() sleeps for matched delay_ms
    rules, then returns the first probabilistic action that trips
    ('error' | 'drop' | 'partial_write' | 'queue_full' | ...) or None."""

    def __init__(self, rules=(), seed: int = 0, sleep=time.sleep):
        self._lock = threading.Lock()
        self._sleep = sleep
        self._seed = int(seed)
        self._fired: dict[str, int] = {}
        self._by_site: dict[str, list[_RuleState]] = {}
        self.configure(rules)

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0, sleep=time.sleep):
        return cls(parse_fault_spec(spec), seed=seed, sleep=sleep)

    def configure(self, rules, seed: int | None = None) -> None:
        """Replace the active rule set (a string spec or parsed rules) and
        re-seed every rule's RNG stream, so every configure() starts a
        reproducible run. `seed` optionally replaces the injector seed
        (the runtime-reconfig admin op passes the campaign's seed)."""
        if isinstance(rules, str):
            rules = parse_fault_spec(rules)
        if seed is not None:
            self._seed = int(seed)
        by_site: dict[str, list[_RuleState]] = {}
        for rule in rules:
            states = by_site.setdefault(rule.site, [])
            states.append(_RuleState(rule, self._seed, len(states)))
        with self._lock:
            self._by_site = by_site
            self._hits: dict[str, int] = {}

    def clear(self) -> None:
        self.configure(())

    def enabled(self) -> bool:
        return bool(self._by_site)

    def fired(self) -> dict[str, int]:
        """Cumulative '<site>:<kind>' trip counts (tests/debugging);
        survives configure()/clear() so a scenario can count across
        phases."""
        with self._lock:
            return dict(self._fired)

    def describe(self) -> dict:
        """Live rule set + per-rule runtime state (the /debug/faults GET
        body and the OP_FAULTS_SET reply)."""
        with self._lock:
            rules = []
            for site in sorted(self._by_site):
                for state in self._by_site[site]:
                    r = state.rule
                    rules.append(
                        {
                            "site": r.site,
                            "kind": r.kind,
                            "value": r.value,
                            "after": r.after,
                            "times": r.times,
                            "fires": state.fires,
                            "hits": self._hits.get(site, 0),
                            "spec": r.to_spec(),
                        }
                    )
            return {
                "seed": self._seed,
                "rules": rules,
                "fired": dict(self._fired),
            }

    def fire(self, site: str) -> str | None:
        # Lock-free fast path: an always-constructed injector must cost
        # nothing on the hot path while no faults are configured. The
        # dict reference swaps atomically in configure(); a stale empty
        # read races only with the act of arming faults, which has no
        # ordering guarantee anyway.
        if not self._by_site:
            return None
        delay_ms = 0.0
        action: str | None = None
        with self._lock:
            states = self._by_site.get(site, ())
            if not states:
                return None
            hits = self._hits.get(site, 0) + 1
            self._hits[site] = hits
            for state in states:
                rule = state.rule
                if rule.kind == "delay_ms":
                    if state.armed(hits):
                        delay_ms += rule.value
                        state.fires += 1
                elif state.armed(hits):
                    # Draw even when an earlier rule already tripped:
                    # each rule's stream advances once per armed hit, so
                    # rule composition never shifts a neighbor's draws.
                    tripped = state.rng.random() < rule.value
                    if tripped and action is None:
                        action = rule.kind
                        state.fires += 1
            if delay_ms > 0:
                key = f"{site}:delay_ms"
                self._fired[key] = self._fired.get(key, 0) + 1
            if action is not None:
                key = f"{site}:{action}"
                self._fired[key] = self._fired.get(key, 0) + 1
        if delay_ms > 0:
            self._sleep(delay_ms / 1e3)
        return action
