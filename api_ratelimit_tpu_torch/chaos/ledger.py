"""Port of chaos/ledger.py (unchanged): the admission ledger, every admit
the SUT grants stamped at grant.

One ledger per campaign run. The harness records:

    record_admit(key, label, n, role)  on every granted token batch —
        label is the window label COMPUTED WITH THE ADMITTING ROLE'S
        CLOCK at the moment of the offer, so a skewed clock that opens
        an extra window label grows the bound (limit x labels) by
        exactly the budget the SUT legitimately re-granted, while a
        backward step into a still-resident window label adds nothing.

    note_snapshot() after each SUCCESSFUL snapshot_once — the crash
        baseline becomes a copy of the current per-key admit counts
        (what a restore would bring back).

    note_snapshot_corrupt() when the nemesis poisons the newest
        snapshot — the baseline is dropped to zero (restore CRC-rejects
        and cold-boots), so the next kill charges the FULL counter loss
        to the crash term.

    note_owner_kill(restored) at an owner kill: crash term grows by
        admits - baseline per key (the counter value the restore loses),
        or the full count when the restore failed.

    note_fed_kill(keys, limit) at an east/west kill: the home forgets
        its committed spend for the current window, so up to `limit`
        extra tokens per fed key can legitimately be re-granted.

    note_evict_loss(count) / note_demote_drop_budget(tokens) feed the
        eviction envelope: the victim tier's overflow_lost_count_sum is
        exact (it counts the tokens on rows it value-ranked out); a
        victim.demote drop fault loses a row silently, so the harness
        budgets a conservative `limit` per armed fire.

All state is plain ints/dicts — finalize() emits a canonical-JSON-safe
document the invariant checker and the artifact both consume.
"""

from __future__ import annotations


class AdmissionLedger:
    def __init__(self):
        # key -> total admitted tokens (all windows, whole run)
        self.admits: dict = {}
        # key -> set of window labels any admit was stamped under
        self.labels: dict = {}
        # key -> window EPISODES: +1 each time an admit lands under a
        # different label than the previous admit. On monotonic clocks
        # episodes == |labels| (each label once); under skew a clock
        # stepped back into an already-reclaimed window legitimately
        # re-opens its budget, and the episode count — not the distinct
        # label count — is what the window term must scale by.
        self.episodes: dict = {}
        self._last_label: dict = {}
        # key -> tokens the bound excuses because a crash lost counters
        self.crash_term: dict = {}
        # per-key admit counts at the last intact snapshot
        self._baseline: dict = {}
        self._baseline_valid = True
        # eviction envelope accumulators (engine-path keys share them)
        self.evict_lost = 0
        self.demote_drop_budget = 0
        # denies, for the campaign summary (not part of the bound)
        self.denies = 0
        # role -> kills, for attribution in violation reports
        self.kills: dict = {}

    # -- admission path -------------------------------------------------
    def record_admit(self, key: str, label: int, n: int, role: str) -> None:
        label = int(label)
        self.admits[key] = self.admits.get(key, 0) + int(n)
        self.labels.setdefault(key, set()).add(label)
        if self._last_label.get(key) != label:
            self.episodes[key] = self.episodes.get(key, 0) + 1
            self._last_label[key] = label

    def record_deny(self, key: str) -> None:
        self.denies += 1

    # -- snapshot / crash accounting -------------------------------------
    def note_snapshot(self) -> None:
        self._baseline = dict(self.admits)
        self._baseline_valid = True

    def note_snapshot_corrupt(self) -> None:
        self._baseline_valid = False

    def note_owner_kill(self, restored: bool, keys=None) -> None:
        """keys: restrict the charge to engine-path keys — federation
        state lives outside the owner's snapshot, so fed keys are only
        charged by note_fed_kill, never by an owner crash."""
        self.kills["owner"] = self.kills.get("owner", 0) + 1
        baseline = (
            self._baseline if (restored and self._baseline_valid) else {}
        )
        charge = self.admits.keys() if keys is None else keys
        for key in charge:
            lost = self.admits.get(key, 0) - baseline.get(key, 0)
            if lost > 0:
                self.crash_term[key] = self.crash_term.get(key, 0) + lost
        # the restore (or cold boot) IS the new counter truth
        self._baseline = dict(baseline)
        self._baseline_valid = True

    def note_fed_kill(self, role: str, keys, limit: int) -> None:
        self.kills[role] = self.kills.get(role, 0) + 1
        for key in keys:
            self.crash_term[key] = self.crash_term.get(key, 0) + int(limit)

    # -- eviction envelope ------------------------------------------------
    def note_evict_loss(self, count: int) -> None:
        self.evict_lost += int(count)

    def note_demote_drop_budget(self, tokens: int) -> None:
        self.demote_drop_budget += int(tokens)

    # -- export ------------------------------------------------------------
    def finalize(self) -> dict:
        """Canonical-JSON-safe dump (label sets become sorted lists)."""
        return {
            "admits": dict(sorted(self.admits.items())),
            "labels": {
                k: sorted(v) for k, v in sorted(self.labels.items())
            },
            "episodes": dict(sorted(self.episodes.items())),
            "crash_term": dict(sorted(self.crash_term.items())),
            "evict_lost": self.evict_lost,
            "demote_drop_budget": self.demote_drop_budget,
            "denies": self.denies,
            "kills": dict(sorted(self.kills.items())),
        }
