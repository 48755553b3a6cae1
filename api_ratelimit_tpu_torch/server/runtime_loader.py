"""Port of api_ratelimit_tpu/server/runtime_loader.py: runtime config loading
and hot reload, the goruntime equivalent.

The reference watches RUNTIME_ROOT (symlink-swap deploys, RUNTIME_WATCH_ROOT
=true) or RUNTIME_ROOT/RUNTIME_SUBDIRECTORY directly, snapshots every file
under it, and fires a callback on change (src/server/server_impl.go:191-206);
the service reloads rule YAMLs from the snapshot (SURVEY.md §3.4).

Snapshot key convention matches goruntime's: path relative to the watched
app directory with '/' -> '.' and the file extension stripped, so
`config/basic.yaml` -> `config.basic` and the service's `config.` prefix
filter (ratelimit.go:94-102) behaves identically.

Change detection (RUNTIME_WATCHER):

  * "inotify" — Linux inotify via ctypes (no third-party deps), the
    fsnotify analog of the reference's watcher. Event-driven: zero
    steady-state scan work on the serving process; a low-cadence safety
    rescan backstops anything inotify can't see (NFS, bind quirks).
  * "poll" — mtime/size re-walk every RUNTIME_POLL_INTERVAL seconds
    (default 250ms). O(files) steady-state work, but the scan cost at
    rate-limit-config scale (tens of files) is negligible, and a re-walk
    through the root symlink observes symlink-swap deploys trivially.
  * "auto" (default) — inotify where it works, poll fallback elsewhere.

The watcher thread is a daemon; stop() joins it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
import struct
import threading
from typing import Callable, Sequence

logger = logging.getLogger("ratelimit.server.runtime")


class _InotifyWatcher:
    """Minimal Linux inotify binding (ctypes; no watchdog/pyinotify
    dependency). Watches the runtime directory tree PLUS each
    watched path's parent, so a symlink-swap deploy — atomically repointing
    `current` — raises IN_MOVED_TO/IN_CREATE in the parent even though
    nothing under the OLD target changed. After every event burst the whole
    watch set is rebuilt from a fresh fd: config trees are tiny (tens of
    directories), and rebuild-then-rescan can never miss a directory
    created mid-burst the way incremental watch bookkeeping can."""

    _IN_CLOEXEC = 0o2000000
    _IN_NONBLOCK = 0o4000
    # modify|attrib|close_write|moved_from|moved_to|create|delete|
    # delete_self|move_self
    _MASK = 0x2 | 0x4 | 0x8 | 0x40 | 0x80 | 0x100 | 0x200 | 0x400 | 0x800

    def __init__(self, paths: Sequence[str]):
        libname = ctypes.util.find_library("c")
        self._libc = ctypes.CDLL(libname or "libc.so.6", use_errno=True)
        # touch the symbols so "no inotify on this libc/OS" raises here,
        # inside the caller's auto-fallback, not later in the watch thread
        self._libc.inotify_init1
        self._libc.inotify_add_watch
        self._paths = [os.path.abspath(p) for p in paths]
        self.fd = -1
        self._open()

    def _dirs(self):
        seen = []
        for root in self._paths:
            parent = os.path.dirname(root)
            if parent and parent not in seen:
                seen.append(parent)
            for dirpath, dirnames, _files in os.walk(root, followlinks=True):
                if dirpath not in seen:
                    seen.append(dirpath)
        return seen

    def _open(self) -> None:
        fd = self._libc.inotify_init1(self._IN_NONBLOCK | self._IN_CLOEXEC)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        watched = 0
        for d in self._dirs():
            # fsencode, not .encode(): os.walk surrogate-escapes non-UTF-8
            # directory names, which strict UTF-8 would refuse to encode
            if self._libc.inotify_add_watch(fd, os.fsencode(d), self._MASK) >= 0:
                watched += 1
        if watched == 0:
            os.close(fd)
            raise OSError(ctypes.get_errno(), "inotify_add_watch failed for all dirs")
        self.fd = fd

    def drain(self) -> None:
        """Consume every queued event; the caller rescans regardless of
        event content, so names/masks are not parsed beyond the framing."""
        while True:
            try:
                buf = os.read(self.fd, 65536)
            except BlockingIOError:
                return
            except OSError:
                return
            if not buf:
                return
            # frames: wd(i) mask(I) cookie(I) len(I) name[len] — only len is
            # needed to step the cursor
            off = 0
            while off + 16 <= len(buf):
                _wd, _mask, _cookie, nlen = struct.unpack_from("iIII", buf, off)
                off += 16 + nlen

    def rebuild(self) -> None:
        os.close(self.fd)
        # invalidate BEFORE reopening: if _open() raises, close() must not
        # re-close the stale number (likely reused by an unrelated fd)
        self.fd = -1
        self._open()

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class StaticSnapshot:
    def __init__(self, entries: dict[str, str]):
        self._entries = dict(entries)

    def keys(self) -> Sequence[str]:
        return sorted(self._entries)

    def get(self, key: str) -> str:
        return self._entries.get(key, "")


class StaticRuntimeLoader:
    """Fixed in-memory runtime — tests and the config linter use this."""

    def __init__(self, entries: dict[str, str]):
        self._snapshot = StaticSnapshot(entries)
        self._callbacks: list[Callable[[], None]] = []

    def snapshot(self) -> StaticSnapshot:
        return self._snapshot

    def add_update_callback(self, callback: Callable[[], None]) -> None:
        self._callbacks.append(callback)

    def set_entries(self, entries: dict[str, str]) -> None:
        self._snapshot = StaticSnapshot(entries)
        for cb in list(self._callbacks):
            cb()


def _key_for(relpath: str) -> str:
    base, _ext = os.path.splitext(relpath)
    return base.replace(os.sep, ".")


def scan_signature(root: str, ignore_dotfiles: bool = False) -> tuple:
    """Stat-only walk (through symlinks): the change signature of
    (relpath, mtime_ns, size) triples. Cheap enough to poll."""
    sig = []
    for dirpath, dirnames, filenames in os.walk(root, followlinks=True):
        if ignore_dotfiles:
            dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        dirnames.sort()
        for fname in sorted(filenames):
            if ignore_dotfiles and fname.startswith("."):
                continue
            path = os.path.join(dirpath, fname)
            try:
                st = os.stat(path)
            except OSError:
                continue  # racing a deploy swap; next scan settles
            sig.append((os.path.relpath(path, root), st.st_mtime_ns, st.st_size))
    return tuple(sig)


def scan_directory(
    root: str, ignore_dotfiles: bool = False
) -> tuple[dict[str, str], tuple]:
    """Full walk: {key: contents} plus the change signature."""
    entries: dict[str, str] = {}
    sig = []
    for dirpath, dirnames, filenames in os.walk(root, followlinks=True):
        if ignore_dotfiles:
            dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        dirnames.sort()
        for fname in sorted(filenames):
            if ignore_dotfiles and fname.startswith("."):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            try:
                st = os.stat(path)
                # errors="replace", not strict: a stray binary file must
                # reach the YAML loader as (invalid) text so the reload
                # counts config_load_error and keeps the last good config
                # — a UnicodeDecodeError here would escape the reload
                # handler and kill hot reload for good.
                with open(path, "r", encoding="utf-8", errors="replace") as f:
                    entries[_key_for(rel)] = f.read()
                sig.append((rel, st.st_mtime_ns, st.st_size))
            except OSError:
                continue  # racing a deploy swap; next scan settles
    return entries, tuple(sig)


class DirectoryRuntimeLoader:
    """Filesystem runtime with a polling watcher (goruntime loader.IFace)."""

    def __init__(
        self,
        runtime_path: str,
        runtime_subdirectory: str = "",
        ignore_dotfiles: bool = False,
        poll_interval_seconds: float = 0.25,
        watcher: str = "auto",
        safety_rescan_seconds: float = 5.0,
    ):
        if watcher not in ("auto", "inotify", "poll"):
            raise ValueError(f"watcher must be auto|inotify|poll, got {watcher!r}")
        # goruntime's RUNTIME_WATCH_ROOT flag only chooses which directory
        # the inotify watcher observes (root, to catch symlink-swap deploys);
        # keys are always relative to runtime_path/subdirectory. A polling
        # re-walk resolves the symlink every scan, so both deploy styles are
        # covered without a flag here — the service keeps its own copy of
        # the flag for the `config.` key filter (ratelimit.go:94-102).
        self._dir = (
            os.path.join(runtime_path, runtime_subdirectory)
            if runtime_subdirectory
            else runtime_path
        )
        self._ignore_dotfiles = ignore_dotfiles
        self._poll_interval = poll_interval_seconds
        self._watcher_mode = watcher
        self._safety_rescan = safety_rescan_seconds
        self._callbacks: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        entries, self._sig = scan_directory(self._dir, ignore_dotfiles)
        self._snapshot = StaticSnapshot(entries)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._inotify: _InotifyWatcher | None = None
        self._wake_w: int | None = None  # write end of the stop-wake pipe
        self.watching_with: str | None = None  # set by start_watching

    def snapshot(self) -> StaticSnapshot:
        with self._lock:
            return self._snapshot

    def add_update_callback(self, callback: Callable[[], None]) -> None:
        self._callbacks.append(callback)

    def refresh(self) -> bool:
        """One scan; swap the snapshot and fire callbacks when changed.
        Returns whether a change was seen (exposed for tests). Contents are
        only read when the stat signature differs."""
        with self._lock:
            unchanged = (
                scan_signature(self._dir, self._ignore_dotfiles) == self._sig
            )
        if unchanged:
            return False
        entries, sig = scan_directory(self._dir, self._ignore_dotfiles)
        with self._lock:
            if sig == self._sig:
                return False
            self._sig = sig
            self._snapshot = StaticSnapshot(entries)
        logger.info("runtime changed (%d files)", len(entries))
        for cb in list(self._callbacks):
            try:
                cb()
            except Exception:
                logger.exception("runtime update callback failed")
        return True

    def start_watching(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        if self._watcher_mode in ("auto", "inotify"):
            try:
                self._inotify = _InotifyWatcher([self._dir])
            except Exception as e:
                if self._watcher_mode == "inotify":
                    raise
                logger.info(
                    "inotify unavailable (%s); polling every %.3fs",
                    e,
                    self._poll_interval,
                )
                self._inotify = None
        self.watching_with = "inotify" if self._inotify is not None else "poll"

        if self._inotify is None:
            loop = self._poll_loop
        else:
            loop = self._inotify_loop
        self._thread = threading.Thread(target=loop, name="runtime-watch", daemon=True)
        self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._poll_interval):
            try:
                self.refresh()
            except Exception:
                logger.exception("runtime scan failed")

    def _inotify_loop(self) -> None:
        """Event-driven loop: block in select on (inotify fd, stop pipe);
        on events, drain + rebuild the watch set (new deploy directories
        get watched), then rescan. The safety-rescan timeout backstops
        filesystems whose changes inotify cannot observe."""
        import select

        ino = self._inotify
        wake_r, self._wake_w = os.pipe()
        try:
            while not self._stop.is_set():
                try:
                    ready, _, _ = select.select(
                        [ino.fd, wake_r], [], [], self._safety_rescan
                    )
                except OSError:
                    ready = []
                if self._stop.is_set():
                    return
                if ino.fd in ready:
                    ino.drain()
                    try:
                        ino.rebuild()
                    except Exception:
                        logger.exception(
                            "inotify rebuild failed; falling back to polling"
                        )
                        self.watching_with = "poll"
                        self._poll_loop()
                        return
                try:
                    self.refresh()
                except Exception:
                    logger.exception("runtime scan failed")
        finally:
            # the write end (_wake_w) belongs to stop(): closing it here
            # would race stop()'s check-then-write into a reused fd
            ino.close()
            os.close(wake_r)

    def stop(self) -> None:
        self._stop.set()
        if self._wake_w is not None:
            try:
                # wake the select immediately; if the thread already exited
                # and closed the read end, this raises BrokenPipeError —
                # safe, because only stop() ever closes the write end
                os.write(self._wake_w, b"x")
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._wake_w is not None:
            os.close(self._wake_w)
            self._wake_w = None
        self._inotify = None
