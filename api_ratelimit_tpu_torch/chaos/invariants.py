"""Port of chaos/invariants.py (unchanged): the composed admission bound,
with per-term attribution.

For every tracked key the checker asserts

    admits(key) <= limit * episodes(key)        (window budget —
                   episodes = admitting-clock window-label transitions,
                   so clock skew grows the budget by exactly the
                   windows it re-opened; see ledger.py)
                 + lease_outstanding(key-class) (granted, unconsumed)
                 + crash_term(key)              (counters a kill lost)
                 + evict_envelope               (victim overflow + drops)
                 + fed_term(key-class)          (reclaim double-grants)

Each term is owned by one subsystem's ledger, so a violation names the
broken ledger line, not just "over limit". When a nemesis class was NOT
in the composed set, its term must be identically zero — the checker
degrades to that tighter per-subsystem bound and flags a nonzero term
as its own violation kind ("term_active_without_nemesis"), which is how
a bookkeeping bug in the harness itself surfaces instead of silently
widening the bound.

check_invariants(..., weaken=<term>) zeroes one term before comparing —
the self-test hook: weaken "crash" and run an owner-kill timeline and
the checker MUST report a violation blaming exactly that term, which
the shrinker then reduces to a minimal repro.
"""

from __future__ import annotations

TERM_NAMES = ("window_budget", "lease", "crash", "evict", "fed")

# term -> the nemesis classes that may legitimately feed it; an empty
# tuple means the term is workload-driven (always allowed to be > 0)
_TERM_SOURCES = {
    "crash": ("process_kill", "snapshot_corrupt"),
    "evict": (),  # keyspace pressure alone can evict — always allowed
    "lease": (),
    "fed": ("partition",),
    "window_budget": (),
}


def _terms_for_key(key: str, kind: str, limit: int, ledger_doc: dict,
                   lease_outstanding: int, fed_reclaimed: int) -> dict:
    episodes = ledger_doc.get("episodes", {}).get(
        key, len(ledger_doc["labels"].get(key, []))
    )
    terms = {
        "window_budget": int(limit) * max(1, int(episodes)),
        "lease": int(lease_outstanding) if kind == "lease" else 0,
        "crash": int(ledger_doc["crash_term"].get(key, 0)),
        "evict": (
            int(ledger_doc["evict_lost"])
            + int(ledger_doc["demote_drop_budget"])
            if kind in ("lease", "plain")
            else 0
        ),
        "fed": int(fed_reclaimed) if kind == "fed" else 0,
    }
    return terms


def check_invariants(
    ledger_doc: dict,
    key_limits: dict,
    key_kinds: dict,
    classes,
    lease_outstanding: int = 0,
    fed_reclaimed: int = 0,
    weaken: str | None = None,
) -> list:
    """All violations for one finished run (empty list == verdict ok).

    ledger_doc: AdmissionLedger.finalize() output.
    key_limits: key -> per-window limit.
    key_kinds:  key -> "lease" | "fed" | "plain".
    classes:    the nemesis classes this run composed (for degradation).
    lease_outstanding: unconsumed granted lease tokens at run end.
    fed_reclaimed: reclaimed_tokens_total summed over both coordinators.
    weaken: zero one term before comparing (self-test hook).
    """
    if weaken is not None and weaken not in TERM_NAMES:
        raise ValueError(
            f"unknown term {weaken!r}; terms: {TERM_NAMES}"
        )
    classes = set(classes)
    violations = []
    for key, limit in sorted(key_limits.items()):
        kind = key_kinds[key]
        admits = int(ledger_doc["admits"].get(key, 0))
        terms = _terms_for_key(
            key, kind, limit, ledger_doc, lease_outstanding, fed_reclaimed
        )
        # degradation: a term fed only by disabled nemesis classes must
        # be zero — a nonzero value is a harness-ledger bug in itself
        for term, sources in _TERM_SOURCES.items():
            if sources and terms[term] and not (classes & set(sources)):
                violations.append(
                    {
                        "kind": "term_active_without_nemesis",
                        "key": key,
                        "term": term,
                        "value": terms[term],
                        "classes": sorted(classes),
                    }
                )
        effective = dict(terms)
        if weaken is not None:
            effective[weaken] = 0
        bound = sum(effective.values())
        if admits > bound:
            # blame: the zeroed/smallest set of terms whose restoration
            # would re-admit the run — names the broken ledger line
            blame = [
                t
                for t in TERM_NAMES
                if effective[t] < terms[t]
                or (terms[t] > 0 and admits <= bound + terms[t])
            ]
            if weaken is not None:
                blame = [weaken]
            violations.append(
                {
                    "kind": "admission_bound",
                    "key": key,
                    "key_kind": kind,
                    "admits": admits,
                    "bound": bound,
                    "over_by": admits - bound,
                    "terms": terms,
                    "weakened": weaken,
                    "blame": blame or ["window_budget"],
                }
            )
    return violations
