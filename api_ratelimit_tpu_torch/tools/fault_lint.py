"""Port of tools/fault_lint.py: the fault-site lint, registry docstring <->
wired fire() sites <-> tests, over the port.

The port's testing/faults.py documents the chaos-site registry (the contract the
FAULT_INJECT grammar, POST /debug/faults, and the chaos nemesis menu
all draw from). This lint cross-checks three views of that registry:

    documented   site names parsed from the faults.py registry docstring
    wired        sites that actually reach a FaultInjector.fire() call
                 in the port package — either a site literal passed to
                 fire() or a FAULT_SITE_* constant fired in its defining
                 module
    tested       sites named in at least one tests/test_torch_*.py file
                 (the port's own tests)

and fails on any asymmetry: a documented site nobody fires (dead
documentation), a fired site the docstring hides (unreviewable chaos
surface), or a site no test exercises (a fault arm that can rot).

    python -m api_ratelimit_tpu_torch.tools.fault_lint

Exit 0 clean, 1 findings, 2 usage. Wired into the tests via
tests/test_torch_chaos_engine.py.
"""

from __future__ import annotations

import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
TESTS = os.path.join(REPO, "tests")
TEST_GLOB = re.compile(r"^test_torch_.*\.py$")

# a registry docstring row: indented site name, two+ spaces, prose
_DOC_SITE = re.compile(r"^\s{4}([a-z][a-z_]*(?:\.[a-z_]+)+)\s{2,}\S")
_CONST = re.compile(r'^(FAULT_SITE_\w+)\s*=\s*"([a-z_.]+)"', re.M)
_FIRE_LITERAL = re.compile(r'\.fire\(\s*\n?\s*"([a-z_.]+)"')
_FIRE_CONST = re.compile(r"\.fire\(\s*\n?\s*(FAULT_SITE_\w+)")


def documented_sites() -> set:
    from ..testing import faults

    sites = set()
    for line in (faults.__doc__ or "").splitlines():
        match = _DOC_SITE.match(line)
        if match:
            sites.add(match.group(1))
    return sites


def _py_files(root: str):
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fname in files:
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def wired_sites(pkg: str = PKG) -> set:
    sites = set()
    for path in _py_files(pkg):
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        sites.update(_FIRE_LITERAL.findall(text))
        consts = dict(_CONST.findall(text))
        for name in _FIRE_CONST.findall(text):
            if name in consts:
                sites.add(consts[name])
    return sites


def tested_sites(sites, tests_dir: str = TESTS) -> dict:
    """site -> list of the port's test files that mention it."""
    hits = {site: [] for site in sites}
    for path in _py_files(tests_dir):
        if not TEST_GLOB.match(os.path.basename(path)):
            continue
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        for site in sites:
            if site in text:
                hits[site].append(os.path.basename(path))
    return hits


def run(pkg: str = PKG, tests_dir: str = TESTS) -> list:
    documented = documented_sites()
    wired = wired_sites(pkg)
    findings = []
    if not documented:
        return ["faults.py registry docstring parsed to ZERO sites — "
                "the docstring format or this lint's parser broke"]
    for site in sorted(documented - wired):
        findings.append(
            f"{site}: documented in testing/faults.py but never fired — "
            f"dead registry row or a lost fire() call"
        )
    for site in sorted(wired - documented):
        findings.append(
            f"{site}: fire()d in the package but missing from the "
            f"testing/faults.py registry docstring — document it"
        )
    for site, files in sorted(
        tested_sites(documented | wired, tests_dir).items()
    ):
        if not files:
            findings.append(
                f"{site}: no tests/test_torch_*.py mentions this site — "
                f"every fault arm needs at least one exercising test"
            )
    return findings


def main(argv=None) -> int:
    findings = run()
    for finding in findings:
        print(finding)
    if findings:
        print(f"fault_lint: {len(findings)} finding(s)")
        return 1
    sites = sorted(documented_sites())
    print(f"fault_lint: clean ({len(sites)} sites documented+wired+tested)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
