"""threadcheck of the port (`ray_lightning_tpu_torch/analysis/concurrency.py`)
held against the JAX package's (`ray_lightning_tpu/analysis/concurrency.py`).

Every fixture source of `tests/test_concurrency_lint.py` (each rule's fire
case and its sanctions, read from that file's AST, so a fixture added
there is held here too) goes through both checkers, alone and the
cross-file pair as one package: the (rule, line) sets are equal. Then the
port's locks: its `san_lock` names are the package-wide identity (a
cycle across two files of the port's import path is found), and the port
itself lints clean under threadcheck. Discrete checks: equality.
"""
from __future__ import annotations

import ast
import os

import pytest

from ray_lightning_tpu.analysis.concurrency import (
    check_concurrency_sources as jax_check,
)
from ray_lightning_tpu.analysis.concurrency import summarize as jax_summarize
from ray_lightning_tpu_torch.analysis.concurrency import (
    check_concurrency_paths,
    check_concurrency_sources,
    summarize,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(ROOT, "tests", "test_concurrency_lint.py")


def _fixtures() -> dict:
    """name -> source: every string assigned to ``_SRC_*``, ``src``,
    ``f1`` or ``f2`` in the JAX test file (named by its test)."""
    tree = ast.parse(open(JAX_TESTS, encoding="utf-8").read())
    out = {}

    def grab(body, where):
        for node in body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                name = node.targets[0].id
                if name.startswith("_SRC") or name in ("src", "f1", "f2"):
                    out[f"{where}:{name}"] = node.value.value

    grab(tree.body, "module")
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            grab(node.body, node.name)
    return out


FIXTURES = _fixtures()


def pairs(fs):
    return sorted((f.rule, f.line) for f in fs)


def test_fixtures_were_found():
    # every rule's fire case and the cross-file pair
    names = set(FIXTURES)
    assert {"module:_SRC_701_FIRE", "module:_SRC_702_FIRE",
            "module:_SRC_703_FIRE", "module:_SRC_704_FIRE",
            "module:_SRC_705_FIRE"} <= names
    assert {"test_rlt702_cycle_detected_across_files:f1",
            "test_rlt702_cycle_detected_across_files:f2"} <= names
    assert len(FIXTURES) >= 18


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_same_findings_as_jax(name):
    src = FIXTURES[name]
    want = pairs(jax_check([("fixture.py", src)]))
    got = pairs(check_concurrency_sources([("fixture.py", src)]))
    assert got == want
    if name.startswith("module:_SRC_"):
        assert want, "a rule's fire case must fire"


def test_cross_file_cycle_same_as_jax_and_on_the_port_import_path():
    """The pair of files whose san_locks nest in opposite orders: one
    RLT702 across them in both checkers; written against the port's
    import path of `san_lock`, the same."""
    key = "test_rlt702_cycle_detected_across_files"
    f1, f2 = FIXTURES[f"{key}:f1"], FIXTURES[f"{key}:f2"]
    both = [("one.py", f1), ("two.py", f2)]
    assert pairs(check_concurrency_sources(both)) == pairs(jax_check(both))
    assert [f.rule for f in check_concurrency_sources(both)] == ["RLT702"]
    ported = [(n, s.replace("ray_lightning_tpu.analysis.lockwatch",
                            "ray_lightning_tpu_torch.analysis.lockwatch"))
              for n, s in both]
    fs = check_concurrency_sources(ported)
    assert [f.rule for f in fs] == ["RLT702"]
    assert "x.alpha" in fs[0].message and "x.beta" in fs[0].message


def test_summarize_equals_jax():
    fs = (check_concurrency_sources([("a.py", FIXTURES["module:_SRC_701_FIRE"])])
          + check_concurrency_sources(
              [("b.py", FIXTURES["module:_SRC_703_FIRE"])]))
    jfs = (jax_check([("a.py", FIXTURES["module:_SRC_701_FIRE"])])
           + jax_check([("b.py", FIXTURES["module:_SRC_703_FIRE"])]))
    assert summarize(fs) == jax_summarize(jfs) == {
        "total": 2, "by_rule": {"RLT701": 1, "RLT703": 1}}


@pytest.fixture(scope="module")
def package_findings():
    return check_concurrency_paths(
        [os.path.join(ROOT, "ray_lightning_tpu_torch")])


def test_port_lints_clean_under_threadcheck(package_findings):
    """No race, lock-order cycle, leaked thread, unsafe handler or
    unsanctioned blocking call under a lock in the port (the build and
    library locks held through their builds carry the JAX package's
    suppressions and reasons)."""
    assert package_findings == [], "\n".join(
        f.format() for f in package_findings)
