"""What the benchmark imports: never JAX or the JAX package, and the
reference nothing of the program."""

import ast
import os

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "api_ratelimit_tpu"}
# the yardstick: traffic, reference, comparison arithmetic, byte counts
PLAIN = ("reference.py", "keys.py", "pool.py", "roofline.py")


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def sources():
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    seen = {}
    for path in sources():
        bad = top_level_imports(path) & FORBIDDEN
        if bad:
            seen[path] = bad
    assert not seen


def test_the_comparison_is_by_whole_top_level_name():
    assert "api_ratelimit_tpu_torch" not in FORBIDDEN
    assert "api_ratelimit_tpu_torch".split(".", 1)[0] != "api_ratelimit_tpu"


@pytest.mark.parametrize("name", PLAIN)
def test_the_yardstick_imports_nothing_of_the_program(name):
    allowed = {"__future__", "numpy", "dataclasses"}
    assert top_level_imports(os.path.join(BENCH, name)) <= allowed
