"""The frontends: F threads, each with one pool block in flight at the
owner, as a frontend waits on its owner: a closed loop, in which a frontend
sends its next block as soon as its counters return.

A frontend records each block in preallocated arrays and keeps, of each
answer, only the counters of the rows the comparison will read (`keep`:
the rows of each pool block in the sampled sets) and drops the rest, as a
frontend drops an answer once it has replied: an answer kept whole would
hold every counter of the run in memory and have the owner write each next
answer into fresh pages."""

from __future__ import annotations

import threading
import time

import numpy as np

CAPACITY = 1 << 16  # blocks a frontend may send in one run


class Frontend:
    def __init__(self, index: int, blocks: range):
        self.index = index
        self.blocks = blocks
        self.block = np.zeros(CAPACITY, dtype=np.int32)  # pool block sent
        self.t_sent = np.zeros(CAPACITY)  # perf_counter seconds
        self.t_done = np.zeros(CAPACITY)
        self.rows = np.zeros(CAPACITY, dtype=np.int32)  # counters returned; -1 an error
        self.kept: list = []  # the kept counters of each block sent (None: no answer)
        self.errors: list = []
        self.sent = 0  # blocks sent
        self.done = 0  # blocks answered (or failed)


class Loop:
    """Drive `owner.submit_block` from `pool`, one closed-loop thread a
    frontend; `keep[p]` indexes the counters kept of pool block p."""

    def __init__(self, owner, pool, keep: list):
        self._owner = owner
        self._pool = pool
        self._keep = keep
        self.frontends = [Frontend(f, pool.frontend_blocks(f)) for f in range(pool.frontends)]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    @property
    def completed(self) -> int:
        return sum(fe.done for fe in self.frontends)

    def start(self) -> None:
        for fe in self.frontends:
            t = threading.Thread(target=self._run, args=(fe,), name=f"frontend-{fe.index}", daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self, fe: Frontend) -> None:
        blocks = self._pool.blocks
        keep = self._keep
        submit = self._owner.submit_block
        n = len(fe.blocks)
        k = 0
        while not self._stop.is_set() and k < CAPACITY:
            p = fe.blocks[k % n]
            fe.block[k] = p
            fe.t_sent[k] = time.perf_counter()
            fe.sent = k + 1
            try:
                out = submit(blocks[p])
                fe.rows[k] = out.shape[0]
                fe.kept.append(out[keep[p]])
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                fe.rows[k] = -1
                fe.kept.append(None)
                fe.errors.append(f"{type(e).__name__}: {e}")
            fe.t_done[k] = time.perf_counter()
            k += 1
            fe.done = k

    def wait_completed(self, n: int, timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        while self.completed < n:
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.005)
        return True

    def stop(self, timeout: float) -> int:
        """Stop sending; wait up to `timeout` s for the blocks in flight.
        Returns how many never came back."""
        self._stop.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return sum(fe.sent - fe.done for fe in self.frontends)


def window_stats(frontends, t0: float, t1: float) -> dict:
    """What the window [t0, t1] served: blocks completed in it, their rows
    and latencies from their send; blocks sent in it, and how many failed or
    never came back."""
    lat, rows = [], 0
    attempted = failed = 0
    for fe in frontends:
        k = fe.done
        sent, done, got = fe.t_sent[:k], fe.t_done[:k], fe.rows[:k]
        sent_in = (sent >= t0) & (sent < t1)
        stuck = int(fe.sent > k and t0 <= fe.t_sent[k] < t1)
        attempted += int(sent_in.sum()) + stuck
        failed += int((sent_in & (got < 0)).sum()) + stuck
        served = (done >= t0) & (done <= t1) & (got >= 0)
        lat.append((done - sent)[served])
        rows += int(got[served].sum())
    lat_ms = np.concatenate(lat) * 1e3
    return {"blocks": int(lat_ms.size), "rows": rows, "attempted": attempted, "failed": failed,
            "latency_ms": lat_ms}
