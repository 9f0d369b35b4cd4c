"""``python -m ray_lightning_tpu_torch lint`` against the JAX package's
``lint`` contract (`tests/test_lint_cli.py`): exit 0 clean, 1 at or above
the gate (with rule ids in ``--json``), 2 on an invalid invocation; the
severity filter, the gate, ``--disable``, ``--json`` before the
subcommand, dotted module targets and ``--list-rules`` (every rule the
port does not flag carries its reason). Each report's rule ids equal the
JAX CLI's on the same fixture. One subprocess smoke runs the real
``python -m`` path with JAX blocked from import: with no target it lints
the port package, threadcheck on, and finds nothing at any severity.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from ray_lightning_tpu.__main__ import main as jax_main
from ray_lightning_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "ray_lightning_tpu_torch", "models")

#: a mesh-axis typo and a per-step host transfer (JAX's BAD_FIXTURE in
#: torch: ``.cpu()`` where JAX has ``np.asarray`` of the loss)
BAD_FIXTURE = """\
import torch

SPECS = {"w": ("fdsp", None)}        # mesh-axis typo (RLT101)


class FixtureModule:
    def training_step(self, params, batch, rng):
        loss = (params["w"] * batch["x"]).sum()
        host = loss.cpu()            # host transfer (RLT201)
        return loss
"""

#: the JAX CLI's fixture, line for line
JAX_BAD_FIXTURE = """\
import numpy as np
from jax.sharding import PartitionSpec as P
SPECS = {"w": P("fdsp", None)}       # mesh-axis typo (RLT101)


class FixtureModule:
    def training_step(self, params, batch, rng):
        loss = (params["w"] * batch["x"]).sum()
        host = np.asarray(loss)      # host transfer (RLT201)
        return loss
"""

WARN_ONLY = ("class M:\n"
             "    def training_step(self, params, batch, rng):\n"
             "        print('x')\n"
             "        return 0\n")


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip())


def test_bad_fixture_exit_1_with_rule_ids_as_jax(tmp_path, capsys):
    bad, jbad = tmp_path / "bad_module.py", tmp_path / "jax_bad.py"
    bad.write_text(BAD_FIXTURE)
    jbad.write_text(JAX_BAD_FIXTURE)
    assert main(["lint", str(bad), "--json"]) == 1
    report = _json(capsys)
    assert jax_main(["lint", str(jbad), "--json"]) == 1
    jreport = _json(capsys)
    assert report["ok"] is False
    got = sorted((f["rule"], f["line"]) for f in report["findings"])
    want = sorted((f["rule"], f["line"]) for f in jreport["findings"])
    assert got == want == [("RLT101", 3), ("RLT201", 9)]
    assert "FixtureModule.training_step" in {
        f.get("symbol") for f in report["findings"]}
    # --json before the subcommand shares the namespace, as in JAX
    assert main(["--json", "lint", str(bad)]) == 1
    assert _json(capsys)["ok"] is False


def test_severity_and_fail_on_gates_as_jax(tmp_path, capsys):
    warn = tmp_path / "warn.py"
    warn.write_text(WARN_ONLY)
    for cli in (main, jax_main):
        # default gate (error): the warning is reported, not failed on
        assert cli(["lint", str(warn), "--json"]) == 0
        assert _json(capsys)["counts"]["warning"] == 1
        assert cli(["lint", str(warn), "--fail-on", "warning"]) == 1
        capsys.readouterr()
        assert cli(["lint", str(warn), "--severity", "error", "--json"]) == 0
        assert _json(capsys)["findings"] == []


def test_disable_drops_rules(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_FIXTURE)
    assert main(["lint", str(bad), "--disable", "RLT101,RLT201",
                 "--json"]) == 0
    assert _json(capsys)["findings"] == []


def test_dotted_module_and_directory_targets(capsys):
    assert main(["lint", "ray_lightning_tpu_torch.models.llama"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert main(["lint", MODELS]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_invalid_target_exit_2_as_jax(capsys):
    for cli in (main, jax_main):
        assert cli(["lint", "no/such/path.py", "--json"]) == 2
        assert "no such" in _json(capsys)["error"]
    assert main(["lint", "no_such_module_xyz"]) == 2
    assert "no such" in capsys.readouterr().err


def test_list_rules_marks_what_the_port_does_not_flag(capsys):
    assert main(["lint", "--list-rules", "--json"]) == 0
    rules = _json(capsys)
    assert jax_main(["lint", "--list-rules", "--json"]) == 0
    jrules = _json(capsys)
    assert set(rules) == set(jrules)
    for rid, r in rules.items():
        assert (r["name"], r["severity"]) == (jrules[rid]["name"],
                                              jrules[rid]["severity"])
    assert rules["RLT201"]["not_flagged"] is None
    assert rules["RLT301"]["not_flagged"] is None  # tracecheck flags it
    assert "in place" in rules["RLT106"]["not_flagged"]
    assert main(["lint", "--list-rules"]) == 0
    text = capsys.readouterr().out
    line = next(ln for ln in text.splitlines() if ln.startswith("RLT203"))
    assert "[not flagged in the port:" in line


def test_cli_subprocess_self_lint_without_jax():
    """The real ``python -m ray_lightning_tpu_torch lint`` with JAX
    blocked from import: no target lints the package, threadcheck on,
    and finds nothing at any severity (gate note). Exit 1 on a finding
    is held in-process above."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.argv = ['ray_lightning_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('ray_lightning_tpu_torch', "
            "run_name='__main__')")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    ok = subprocess.run(
        [sys.executable, "-c", code, "lint", "--fail-on", "note", "--json"],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert ok.returncode == 0, ok.stderr[-2000:] + ok.stdout[-2000:]
    report = json.loads(ok.stdout.strip())
    assert report["ok"] is True and report["findings"] == []
    assert report["counts"] == {"error": 0, "warning": 0, "note": 0}
    assert report["files"] > 100
