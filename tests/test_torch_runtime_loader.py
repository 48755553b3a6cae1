"""The port's runtime loader (server/runtime_loader.py) beside the JAX
package's: the goruntime key convention, change detection, dotfiles, the
symlink-swap deploy, the inotify watcher (event-driven, through a swap, its
rebuild failure falling back to polling) and the auto mode's fallback. Each
test runs against both modules."""

import os
import sys
import time

import pytest

pytest.importorskip("torch")

from api_ratelimit_tpu.server import runtime_loader as jax_rl  # noqa: E402
from api_ratelimit_tpu_torch.server import runtime_loader as port_rl  # noqa: E402

both = pytest.mark.parametrize("rl", [jax_rl, port_rl], ids=["jax", "port"])
linux_only = pytest.mark.skipif(sys.platform != "linux", reason="inotify is Linux-only")


def mkconfig(root, name, text="domain: d\n"):
    config = root / "config"
    config.mkdir(parents=True, exist_ok=True)
    (config / name).write_text(text)


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@both
def test_key_convention(rl, tmp_path):
    mkconfig(tmp_path, "basic.yaml", "x")
    (tmp_path / "config" / "nested").mkdir()
    (tmp_path / "config" / "nested" / "deep.yml").write_text("y")
    entries, _sig = rl.scan_directory(str(tmp_path))
    assert entries == {"config.basic": "x", "config.nested.deep": "y"}


@both
def test_binary_file_reaches_the_loader_as_text(rl, tmp_path):
    mkconfig(tmp_path, "junk.yaml", "")
    (tmp_path / "config" / "junk.yaml").write_bytes(b"\xff\xfe\x00bad: [\x9c")
    entries, _sig = rl.scan_directory(str(tmp_path))
    assert "config.junk" in entries


@both
def test_refresh_detects_changes(rl, tmp_path):
    mkconfig(tmp_path, "a.yaml", "one")
    loader = rl.DirectoryRuntimeLoader(str(tmp_path))
    fired = []
    loader.add_update_callback(lambda: fired.append(1))
    assert loader.refresh() is False
    mkconfig(tmp_path, "b.yaml", "two")
    assert loader.refresh() is True
    assert fired == [1]
    snap = loader.snapshot()
    assert list(snap.keys()) == ["config.a", "config.b"]
    assert snap.get("config.b") == "two"


@both
def test_subdirectory_and_failing_callback(rl, tmp_path):
    """runtime_path + runtime_subdirectory, and a callback that raises
    does not stop the others."""
    mkconfig(tmp_path / "app", "a.yaml", "one")
    loader = rl.DirectoryRuntimeLoader(str(tmp_path), runtime_subdirectory="app")
    fired = []

    def boom():
        raise RuntimeError("callback bug")

    loader.add_update_callback(boom)
    loader.add_update_callback(lambda: fired.append(1))
    mkconfig(tmp_path / "app", "a.yaml", "changed, longer")
    assert loader.refresh() is True and fired == [1]
    assert loader.snapshot().get("config.a") == "changed, longer"


@both
def test_symlink_swap(rl, tmp_path):
    v1, v2 = tmp_path / "v1", tmp_path / "v2"
    mkconfig(v1, "r.yaml", "old")
    mkconfig(v2, "r.yaml", "new")
    current = tmp_path / "current"
    current.symlink_to(v1)
    loader = rl.DirectoryRuntimeLoader(str(current))
    assert loader.snapshot().get("config.r") == "old"
    tmp = tmp_path / "current.tmp"
    tmp.symlink_to(v2)
    os.replace(tmp, current)
    assert loader.refresh() is True
    assert loader.snapshot().get("config.r") == "new"


@both
def test_ignore_dotfiles(rl, tmp_path):
    mkconfig(tmp_path, "a.yaml", "x")
    mkconfig(tmp_path, ".hidden.yaml", "secret")
    entries, _ = rl.scan_directory(str(tmp_path), ignore_dotfiles=True)
    assert list(entries) == ["config.a"]
    entries, _ = rl.scan_directory(str(tmp_path), ignore_dotfiles=False)
    assert "config..hidden" in entries


@both
def test_poll_watcher(rl, tmp_path):
    mkconfig(tmp_path, "a.yaml", "one")
    loader = rl.DirectoryRuntimeLoader(str(tmp_path), watcher="poll", poll_interval_seconds=0.05)
    try:
        loader.start_watching()
        assert loader.watching_with == "poll"
        mkconfig(tmp_path, "b.yaml", "two")
        assert wait_for(lambda: loader.snapshot().get("config.b") == "two")
    finally:
        loader.stop()


@linux_only
@both
def test_inotify_watcher_event_driven(rl, tmp_path):
    """Poll interval and safety rescan far beyond the wait: only an
    inotify event can deliver the change."""
    mkconfig(tmp_path, "a.yaml", "one")
    loader = rl.DirectoryRuntimeLoader(
        str(tmp_path), watcher="inotify", poll_interval_seconds=3600.0, safety_rescan_seconds=3600.0
    )
    fired = []
    loader.add_update_callback(lambda: fired.append(1))
    try:
        loader.start_watching()
        assert loader.watching_with == "inotify"
        mkconfig(tmp_path, "b.yaml", "two")
        assert wait_for(lambda: fired), "inotify never delivered"
        assert loader.snapshot().get("config.b") == "two"
    finally:
        loader.stop()


@linux_only
@both
def test_inotify_sees_symlink_swap(rl, tmp_path):
    v1, v2 = tmp_path / "v1", tmp_path / "v2"
    mkconfig(v1, "r.yaml", "old")
    mkconfig(v2, "r.yaml", "new")
    current = tmp_path / "current"
    current.symlink_to(v1)
    loader = rl.DirectoryRuntimeLoader(
        str(current), watcher="inotify", poll_interval_seconds=3600.0, safety_rescan_seconds=3600.0
    )
    try:
        loader.start_watching()
        tmp = tmp_path / "current.tmp"
        tmp.symlink_to(v2)
        os.replace(tmp, current)
        assert wait_for(lambda: loader.snapshot().get("config.r") == "new"), "symlink swap never observed"
    finally:
        loader.stop()


@both
def test_watcher_auto_falls_back_to_poll(rl, tmp_path, monkeypatch):
    mkconfig(tmp_path, "a.yaml", "one")

    def boom(paths):
        raise OSError("no inotify here")

    monkeypatch.setattr(rl, "_InotifyWatcher", boom)
    loader = rl.DirectoryRuntimeLoader(str(tmp_path), watcher="auto", poll_interval_seconds=0.05)
    try:
        loader.start_watching()
        assert loader.watching_with == "poll"
        mkconfig(tmp_path, "b.yaml", "two")
        assert wait_for(lambda: loader.snapshot().get("config.b") == "two")
    finally:
        loader.stop()


@both
def test_bad_watcher_mode_rejected(rl, tmp_path):
    with pytest.raises(ValueError):
        rl.DirectoryRuntimeLoader(str(tmp_path), watcher="fswatch")


@linux_only
@both
def test_inotify_rebuild_failure_falls_back_to_poll(rl, tmp_path):
    mkconfig(tmp_path, "a.yaml", "one")
    loader = rl.DirectoryRuntimeLoader(
        str(tmp_path), watcher="inotify", poll_interval_seconds=0.05, safety_rescan_seconds=3600.0
    )
    try:
        loader.start_watching()
        assert loader.watching_with == "inotify"

        def boom():
            raise OSError("inotify watch limit reached")

        loader._inotify.rebuild = boom
        mkconfig(tmp_path, "b.yaml", "two")
        assert wait_for(lambda: loader.watching_with == "poll")
        mkconfig(tmp_path, "c.yaml", "three")
        assert wait_for(lambda: loader.snapshot().get("config.c") == "three")
    finally:
        loader.stop()


def test_port_scan_equals_the_reference(tmp_path):
    """Both modules read one tree (subdirectories, a dotfile, a symlinked
    file) into the same entries and signature."""
    mkconfig(tmp_path, "a.yaml", "one")
    mkconfig(tmp_path, ".b.yaml", "two")
    (tmp_path / "config" / "sub").mkdir()
    (tmp_path / "config" / "sub" / "c.yaml").write_text("three")
    (tmp_path / "config" / "link.yaml").symlink_to(tmp_path / "config" / "a.yaml")
    for ignore in (False, True):
        assert port_rl.scan_directory(str(tmp_path), ignore) == jax_rl.scan_directory(str(tmp_path), ignore)
        assert port_rl.scan_signature(str(tmp_path), ignore) == jax_rl.scan_signature(str(tmp_path), ignore)
