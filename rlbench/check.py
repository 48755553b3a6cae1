"""The comparison that decides `correct`.

Every block the frontends sent during set-up and the window went through the
owner's launches in the order the launch log recorded. The reference
(reference.py) replays those launches, with their clock readings, from an
empty table, for a sample of the slab's sets drawn from the seed plus the
set of the most popular key, and every row of every
answered block that falls in those sets is compared with what the owner
returned: exactly, after the wire's saturation.

The numbers compared, each with its limit:
- mismatched_rows: sampled rows whose counter differs from the reference's,
  plus every row of a block the launch log and the frontends disagree on
  (a block launched twice, never launched, or answered for another); limit 0.
- unanswered_blocks: blocks that never came back, a minute past the close,
  or came back with an error; limit 0.
- checked_rows: how many rows were compared; at least 1, so that an empty
  sample never passes.
- sketch_missing_keys: of the `sketch_topk` keys of the mix that the
  launches carried most rows of (its heavy hitters; a mix with no hot key
  names none), how many hold no lane of the owner's heavy-hitter sketch
  once the loop has stopped; limit 0. The sketch is a space-saving summary
  in which a key that takes a large share of every launch enters in one of
  the first launches and holds a count far above the lowest lane's, so a
  sound update never evicts it; an update that is skipped, or that drops a
  launch's candidates, leaves it out.
"""

from __future__ import annotations

import numpy as np

from .owner import slab_geometry
from .pool import FP_HI, FP_LO, HITS, LIMIT
from .reference import SlabReference, saturate

# the sketch's planes as the program documents them: fp_lo, fp_hi and count
# of each lane; a lane is occupied when its count, read signed, is > 0
SKETCH_FP_LO, SKETCH_FP_HI, SKETCH_COUNT = range(3)
SAMPLE_SET_SHARE = 256  # one set in this many, drawn from the seed
HOT_KEY = 0  # and the set of this key id, the Zipf head


def sample_sets(pool, n_sets: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 0x5E75])
    drawn = rng.choice(n_sets, size=max(1, n_sets // SAMPLE_SET_SHARE), replace=False)
    where = np.flatnonzero(pool.ids.ravel() == HOT_KEY)[:1]
    hot = pool.blocks[:, FP_LO, :].ravel()[where].astype(np.int64) & (n_sets - 1)
    return np.unique(np.concatenate([drawn, hot]))


def sampled_lanes(config: dict, pool, seed: int) -> tuple[np.ndarray, list]:
    """(the sampled sets, the rows of each pool block that fall in them)."""
    n_slots, ways, _ = slab_geometry(config)
    n_sets = n_slots // min(ways, n_slots)
    sets = sample_sets(pool, n_sets, seed)
    member = np.zeros(n_sets, dtype=bool)
    member[sets] = True
    held = member[pool.blocks[:, FP_LO, :] & np.uint32(n_sets - 1)]
    return sets, [np.flatnonzero(h) for h in held]


def compare(config: dict, pool, log, frontends, unanswered: int, sets, lanes,
            planes=None, topk: int = 0) -> dict:
    """The numbers compared, from the launch log, what each frontend kept and
    the sketch's planes at the close."""
    n_slots, ways, burst = slab_geometry(config)
    ref = SlabReference(n_slots, min(ways, n_slots), burst, sets=sets)
    blocks = pool.blocks
    per = pool.n_blocks // pool.frontends
    # each frontend's answered blocks, in the order it sent them
    answered = []
    for fe in frontends:
        ok = np.flatnonzero(fe.rows[: fe.done] >= 0)
        answered.append((fe.block[ok].tolist(), [fe.kept[i] for i in ok], fe.rows[ok].tolist()))
    cursor = [0] * len(frontends)
    mismatched = checked = 0
    faults = []
    rows = pool.block_rows
    for readings, order, chunk_rows, _t0 in log.entries:
        if len(readings) != 1:
            faults.append(f"a launch read the clock {len(readings)} times")
            mismatched += sum(chunk_rows)
            continue
        now = readings[0]
        kept = []
        for p in order:
            f = p // per if p >= 0 else -1
            if f < 0 or cursor[f] >= len(answered[f][0]) or answered[f][0][cursor[f]] != p:
                kept.append(None)  # not sent from here, or sent no answer
                continue
            if answered[f][2][cursor[f]] != rows:
                kept.append(None)  # answered with another number of counters
            else:
                kept.append(answered[f][1][cursor[f]])
            cursor[f] += 1
        pos = 0  # block index within `order`; a launch's chunks run in turn
        for n in chunk_rows:
            if n % rows:
                faults.append(f"a launch of {n} rows splits a {rows}-row block")
                mismatched += n
                continue
            take, got = [], []
            lim_max = hits_max = 0
            for p, k in zip(order[pos : pos + n // rows], kept[pos : pos + n // rows]):
                if k is None:
                    faults.append(f"block {p} launched without a matching answer")
                    mismatched += rows
                    continue
                lim_max = max(lim_max, int(blocks[p, LIMIT].max()))
                hits_max = max(hits_max, int(blocks[p, HITS].max()))
                take.append(blocks[p][:, lanes[p]])
                got.append(k)
            pos += n // rows
            if not got:
                continue
            expected = ref.step(*np.concatenate(take, axis=1), now)
            expected = saturate(expected, np.array([lim_max]), np.array([hits_max]))
            answer = np.concatenate(got).astype(np.int64)
            mismatched += int(np.count_nonzero(answer != expected))
            checked += answer.size
    # answered blocks that no launch carried
    for f, (seq, *_) in enumerate(answered):
        missing = len(seq) - cursor[f]
        if missing:
            faults.append(f"frontend {f}: {missing} answered blocks in no launch")
            mismatched += missing * rows
    failed = sum(int((fe.rows[: fe.done] < 0).sum()) for fe in frontends)
    return {
        "mismatched_rows": mismatched,
        "unanswered_blocks": unanswered + failed,
        "checked_rows": checked,
        "sketch_missing_keys": sketch_missing(pool, planes, heavy_keys(pool, log, topk)),
        "faults": faults[:5],
    }


def heavy_keys(pool, log, k: int) -> np.ndarray:
    """The key ids of the k keys with the most hits over every launch the
    log recorded (set-up and window alike)."""
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    launched = np.zeros(pool.n_blocks, dtype=np.int64)
    for _readings, order, _chunk_rows, _t0 in log.entries:
        for p in order:
            if p >= 0:
                launched[p] += 1
    weights = (pool.blocks[:, HITS, :].astype(np.int64) * launched[:, None]).ravel()
    hits = np.bincount(pool.ids.ravel(), weights=weights)
    return np.argsort(-hits, kind="stable")[:k]


def sketch_missing(pool, planes, ids: np.ndarray) -> int:
    """How many of the keys `ids` hold no occupied lane of `planes`
    (uint32[3, lanes], or None: no sketch)."""
    if ids.size == 0:
        return 0
    if planes is None:
        return int(ids.size)
    planes = np.asarray(planes, dtype=np.uint32)
    occupied = planes[SKETCH_COUNT].view(np.int32) > 0
    held = set(zip(planes[SKETCH_FP_LO][occupied].tolist(), planes[SKETCH_FP_HI][occupied].tolist()))
    flat = pool.ids.ravel()
    missing = 0
    for key in ids.tolist():
        at = int(np.argmax(flat == key))
        b, r = divmod(at, pool.block_rows)
        if (int(pool.blocks[b, FP_LO, r]), int(pool.blocks[b, FP_HI, r])) not in held:
            missing += 1
    return missing


LIMITS = {
    "mismatched_rows": ("<=", 0),
    "unanswered_blocks": ("<=", 0),
    "checked_rows": (">=", 1),
    "sketch_missing_keys": ("<=", 0),
}


def verdict(numbers: dict) -> bool:
    for name, (op, limit) in LIMITS.items():
        value = numbers[name]
        if (op == "<=" and value > limit) or (op == ">=" and value < limit):
            return False
    return True
