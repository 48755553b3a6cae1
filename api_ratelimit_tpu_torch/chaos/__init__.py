"""Port of chaos/: the deterministic chaos campaign engine (Jepsen-style,
in-process), over the port's engine.

A campaign is one seeded run of a closed-loop workload (leases +
federation + victim-tier pressure, all on virtual time) with a nemesis
timeline drawn up front from the same seed:

    nemesis.py     seeded timeline of composed nemesis actions
    harness.py     the in-process SUT: owner engine + lease frontend +
                   east/west federation pair + snapshotter, each role on
                   its own SkewableTimeSource over one fake wall clock
    ledger.py      the admission ledger every admit is stamped into
    invariants.py  the composed admission bound, per-term attribution
    campaign.py    run_campaign / run_seeds + CHAOS artifact assembly
    shrink.py      ddmin a violating timeline to a minimal repro and
                   emit a standalone pytest file

Same seed => byte-identical timeline, ledger, and verdict — the whole
run rides FakeTimeSource virtual time and string-seeded RNG streams, so
a violation found in a 10-seed sweep replays exactly from its seed.

The owner engine runs on `device` (run_campaign(..., device="cuda") by
default, the kernels on the card; "cpu" the plain versions); a seed's
canonical JSON is the same on either, and the same as the JAX package's.
Driver: python -m api_ratelimit_tpu_torch.tools.chaos_campaign.
"""

from .campaign import CampaignConfig, run_campaign, run_seeds  # noqa: F401
from .invariants import check_invariants  # noqa: F401
from .ledger import AdmissionLedger  # noqa: F401
from .nemesis import (  # noqa: F401
    NEMESIS_CLASSES,
    canonical_json,
    draw_timeline,
    timeline_crc,
)
from .shrink import ddmin, emit_repro  # noqa: F401
