"""The port's linter (`ray_lightning_tpu_torch/analysis/linter.py`) held
against the JAX package's (`ray_lightning_tpu/analysis/linter.py`).

* Framework-free rules (RLT001, RLT101/103, RLT206, RLT309, RLT401,
  RLT501, RLT503, RLT504, RLT505, RLT601 and the suppression syntax):
  the same source through both linters gives the same (rule, line) set.
* Retargeted rules (RLT201, RLT202, RLT204, RLT304, RLT402, RLT502 and
  the step-code scope): a JAX fixture and its torch translation, line for
  line, give the same (rule, line) set.
* Rules with no counterpart (RLT203, RLT205; RLT106 and the tracecheck
  and numcheck rules, whose engines are not ported): the registry row
  carries the reason, and the JAX fixture that fires in JAX gives no
  finding of that rule in the port.

The checks are discrete, so the tolerance is equality. The package is
linted once (a module-scoped fixture) and must come out clean.
"""
from __future__ import annotations

import os

import pytest

from ray_lightning_tpu.analysis import findings as jax_findings
from ray_lightning_tpu.analysis.linter import lint_source as jax_lint
from ray_lightning_tpu_torch.analysis import findings
from ray_lightning_tpu_torch.analysis.linter import lint_paths, lint_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ray_lightning_tpu_torch")


def pairs(fs):
    return sorted({(f.rule, f.line) for f in fs})


def port(src):
    return pairs(lint_source(src, "<test>"))


def jax(src):
    return pairs(jax_lint(src, "<test>"))


# ---- framework-free: one source, both linters ------------------------------

FRAMEWORK_FREE = {
    "RLT001 parse error": "def broken(:\n",
    "RLT101/103 PartitionSpec literals": (
        "from jax.sharding import PartitionSpec as P\n"
        "A = P('fdsp', None)\n"
        "B = P('tensor', 'tensor')\n"
        "C = P(('data', 'fsdp'), 'tensor')\n"),
    "RLT206 set iteration in a step": (
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        out = {}\n"
        "        for k in set(batch):\n"
        "            out[k] = batch[k]\n"
        "        return [batch[k] for k in {'a', 'b'}]\n"),
    "RLT401 swallowed worker error and leaked group": (
        "from ray_lightning_tpu.runtime import fit_distributed\n"
        "def train(mf, tf, df):\n"
        "    try:\n"
        "        fit_distributed(mf, tf, df, 4)\n"
        "    except Exception:\n"
        "        pass\n"
        "def launch_all():\n"
        "    g = WorkerGroup(4)\n"
        "    g.start()\n"
        "    return g.run(lambda: 1)\n"),
    "RLT501 telemetry in the loop and an unbounded callback list": (
        "def train(loader, step, recorder, s):\n"
        "    for batch in loader:\n"
        "        s = step(s, batch)\n"
        "        recorder.flush()\n"
        "class Keep(Callback):\n"
        "    def on_train_batch_end(self, trainer, out):\n"
        "        self.events.append(out)\n"),
    "RLT503 whole ledger read in a poll loop": (
        "import time\n"
        "def follow(path):\n"
        "    while True:\n"
        "        spans = read_spans(path)\n"
        "        bounded = read_spans(path, tail_bytes=1 << 20)\n"
        "        time.sleep(1.0)\n"),
    "RLT504 per-token channel sends": (
        "def worker_loop(chan, engine):\n"
        "    while True:\n"
        "        emitted = engine.tick()\n"
        "        for tok in emitted:\n"
        "            chan.send(('tok', tok))\n"),
    "RLT505 silent drops": (
        "def pump(driver, reqs):\n"
        "    for r in reqs:\n"
        "        try:\n"
        "            driver.submit(r)\n"
        "        except Exception:\n"
        "            pass\n"
        "def tick(sched):\n"
        "    sched.take_sheds()\n"
        "    sched.last_sheds.clear()\n"),
    "RLT601 pinned world size": (
        "def setup(jax, global_batch, rank):\n"
        "    assert jax.device_count() == 8\n"
        "    per_host = global_batch // 8\n"
        "    return per_host, rank % 4, global_batch // 3\n"),
    "RLT309 constant prefix": (
        "import numpy as np\n"
        "def fleet(sched, tails, sys_prompt):\n"
        "    for i, tail in enumerate(tails):\n"
        "        sched.submit(Request(rid=str(i),\n"
        "            prompt=np.concatenate([sys_prompt, tail])))\n"),
    "suppression: line, bare and file": (
        "# rlt: disable-file=RLT504\n"
        "def pump(driver, reqs, chan, toks):\n"
        "    for t in toks:\n"
        "        chan.send(t)\n"
        "    for r in reqs:\n"
        "        try:\n"
        "            driver.submit(r)\n"
        "        except Exception:  # rlt: disable=RLT505\n"
        "            pass\n"
        "    return reqs.n // 8  # rlt: disable\n"),
}


@pytest.mark.parametrize("name", list(FRAMEWORK_FREE))
def test_framework_free_rules_match_jax(name):
    src = FRAMEWORK_FREE[name]
    want = jax(src)
    assert port(src) == want
    if not name.startswith("suppression"):
        assert want, "the fixture must fire"


# ---- retargeted: a JAX fixture and its torch translation --------------------

RETARGETED = {
    "RLT201 host transfers in a step": (
        "import numpy as np\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        a = loss.item()\n"
        "        b = loss.tolist()\n"
        "        c = jax.device_get(loss)\n"
        "        d = np.asarray(batch['x'])\n"
        "        return loss\n",
        "import numpy as np\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        a = loss.item()\n"
        "        b = loss.tolist()\n"
        "        c = loss.cpu()\n"
        "        d = np.asarray(batch['x'])\n"
        "        return loss\n"),
    "RLT201 through helpers and a call-form transform": (
        "import jax\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        return self._loss(params, batch)\n"
        "    def _loss(self, params, batch):\n"
        "        return _fetch(params)\n"
        "def _fetch(p):\n"
        "    return jax.device_get(p)\n"
        "def make_step():\n"
        "    def step(p):\n"
        "        return p.item()\n"
        "    return jax.jit(step)\n",
        "import torch\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        return self._loss(params, batch)\n"
        "    def _loss(self, params, batch):\n"
        "        return _fetch(params)\n"
        "def _fetch(p):\n"
        "    return torch.cuda.synchronize()\n"
        "def make_step():\n"
        "    def step(p):\n"
        "        return p.item()\n"
        "    return torch.compile(step)\n"),
    "RLT201 under remat and a custom gradient": (
        "import jax\n"
        "def _inner(x):\n"
        "    return x.item()\n"
        "class Block:\n"
        "    def __call__(self, x):\n"
        "        return jax.checkpoint(_inner)(x)\n"
        "@jax.custom_vjp\n"
        "def f(x):\n"
        "    return x.tolist()\n",
        "import torch\n"
        "def _inner(x):\n"
        "    return x.item()\n"
        "class Block:\n"
        "    def __call__(self, x):\n"
        "        return checkpoint(_inner, x)\n"
        "class F(torch.autograd.Function):\n"
        "    def forward(ctx, x):\n"
        "        return x.tolist()\n"),
    "RLT202 unseeded draws in a step": (
        "import random\n"
        "import numpy as np\n"
        "import jax\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        a = random.random()\n"
        "        b = np.random.normal()\n"
        "        c = jax.random.normal(rng, (2,))\n"
        "        d = jax.random.bernoulli(key(0), 0.5, (2,))\n"
        "        return a + b + c.sum() + d\n",
        "import random\n"
        "import numpy as np\n"
        "import torch\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        a = random.random()\n"
        "        b = np.random.normal()\n"
        "        c = torch.randn(2, generator=rng)\n"
        "        d = torch.bernoulli(torch.full((2,), 0.5), generator=rng)\n"
        "        return a + b + c.sum() + d\n"),
    "RLT204 print in a step": (
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        print('loss', batch['x'])\n"
        "        return 0\n",
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        print('loss', batch['x'])\n"
        "        return 0\n"),
    "RLT304 host syncs and placement in the hot loop": (
        "import jax, numpy as np\n"
        "def train(loader, train_step, state, n):\n"
        "    for batch in loader:\n"
        "        db = jax.device_put(batch)\n"
        "        state, metrics = train_step(state, db)\n"
        "        a = float(metrics['loss'])\n"
        "        b = np.asarray(metrics['acc'])\n"
        "        c = metrics['loss'].item()\n"
        "        if n % 50 == 0:\n"
        "            print(float(metrics['loss']))\n",
        "import torch, numpy as np\n"
        "def train(loader, train_step, state, n):\n"
        "    for batch in loader:\n"
        "        db = batch.to(device)\n"
        "        state, metrics = train_step(state, db)\n"
        "        a = float(metrics['loss'])\n"
        "        b = np.asarray(metrics['acc'])\n"
        "        c = metrics['loss'].item()\n"
        "        if n % 50 == 0:\n"
        "            print(float(metrics['loss']))\n"),
    "RLT304 a wait and an un-prefetched copy": (
        "for i, batch in enumerate(val_loader):\n"
        "    m = eval_step(params, jax.device_put(batch))\n"
        "    m['loss'].block_until_ready()\n",
        "for i, batch in enumerate(val_loader):\n"
        "    m = eval_step(params, batch.cuda())\n"
        "    torch.cuda.synchronize()\n"),
    "RLT402 NaN through where": (
        "import jax.numpy as jnp\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        x = batch['x']\n"
        "        r = jnp.where(x > 0, jnp.log(x), 0.0)\n"
        "        p = jnp.where(m, a / b, 0.0)\n"
        "        q = jnp.where(m, x / jnp.maximum(d, 1e-6), 0.0)\n"
        "        s = jnp.log(jnp.where(x > 0, x, 1.0))\n"
        "        return jnp.log(batch['x']).sum() + r + p + q + s\n",
        "import torch\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        x = batch['x']\n"
        "        r = torch.where(x > 0, torch.log(x), 0.0)\n"
        "        p = torch.where(m, a / b, 0.0)\n"
        "        q = torch.where(m, x / torch.clamp_min(d, 1e-6), 0.0)\n"
        "        s = torch.log(torch.where(x > 0, x, 1.0))\n"
        "        return torch.log(batch['x']).sum() + r + p + q + s\n"),
    "RLT502 compiled callee with growing and sliced shapes": (
        "import jax\n"
        "import jax.numpy as jnp\n"
        "step = jax.jit(lambda p, t: t)\n"
        "def serve(params, prompt, lens):\n"
        "    toks = prompt\n"
        "    for t in range(16):\n"
        "        logits = step(params, toks)\n"
        "        toks = jnp.concatenate([toks, logits[:, None]], axis=1)\n"
        "    for l in lens:\n"
        "        out = step(params, toks[:, :l])\n"
        "        x = step(params, toks[l])\n",
        "import torch\n"
        "import torch.nn.functional as F\n"
        "step = torch.compile(lambda p, t: t)\n"
        "def serve(params, prompt, lens):\n"
        "    toks = prompt\n"
        "    for t in range(16):\n"
        "        logits = step(params, toks)\n"
        "        toks = torch.cat([toks, logits[:, None]], dim=1)\n"
        "    for l in lens:\n"
        "        out = step(params, toks[:, :l])\n"
        "        x = step(params, toks[l])\n"),
    "step scope: loops under a transform are not serving loops": (
        "import jax\n"
        "@jax.jit\n"
        "def step(sched_like, chan_like, tokens):\n"
        "    for t in tokens:\n"
        "        chan_like.send(t)\n"
        "    sched_like.take_sheds()\n"
        "    return tokens\n",
        "import torch\n"
        "@torch.compile\n"
        "def step(sched_like, chan_like, tokens):\n"
        "    for t in tokens:\n"
        "        chan_like.send(t)\n"
        "    sched_like.take_sheds()\n"
        "    return tokens\n"),
}


@pytest.mark.parametrize("name", list(RETARGETED))
def test_retargeted_rules_match_jax_line_for_line(name):
    jsrc, tsrc = RETARGETED[name]
    assert len(jsrc.splitlines()) == len(tsrc.splitlines())
    want = jax(jsrc)
    assert port(tsrc) == want
    if not name.startswith("step scope"):
        assert want, "the fixture must fire"


def test_torch_idioms_beyond_the_jax_spellings():
    """What the port flags that has no JAX spelling: ``.numpy()``,
    ``.to("cpu")`` and an in-place draw in a step, a step-code
    ``backward``, a method given to ``checkpoint``, a ``*param_specs*``
    table with a typo'd and a doubled axis, and
    ``dist.get_world_size()`` pinned."""
    src = ("import torch\n"
           "class M:\n"
           "    def training_step(self, params, batch, rng):\n"
           "        a = batch['x'].numpy()\n"
           "        b = batch['x'].to('cpu')\n"
           "        c = torch.empty(3).uniform_()\n"
           "        d = torch.empty(3).uniform_(generator=rng)\n"
           "        return a, b, c, d\n"
           "class G(torch.autograd.Function):\n"
           "    @staticmethod\n"
           "    def backward(ctx, g):\n"
           "        return g.cpu()\n"
           "def my_param_specs(cfg):\n"
           "    return {'w': ('tensor', None), 'v': ('fdsp', None),\n"
           "            'u': (('data', 'data'), None), 'names': 'w'}\n"
           "LAYER_SPECS = {'wo': (None, 'tensr')}\n"
           "ok = dist.get_world_size() == 4\n"
           "class Block:\n"
           "    def __call__(self, x):\n"
           "        return checkpoint(self._inner, x)\n"
           "    def _inner(self, x):\n"
           "        return x.item()\n")
    assert port(src) == [("RLT101", 14), ("RLT101", 16), ("RLT103", 15),
                         ("RLT201", 4), ("RLT201", 5), ("RLT201", 12),
                         ("RLT201", 22), ("RLT202", 6), ("RLT601", 17)]


# ---- rules with no counterpart ------------------------------------------------

NO_COUNTERPART = {
    "RLT203": (
        "import time\n"
        "class M:\n"
        "    def training_step(self, params, batch, rng):\n"
        "        t = time.time()\n"
        "        return t\n"),
    "RLT205": (
        "import jax\n"
        "from functools import partial\n"
        "@partial(jax.jit, static_argnames=('cfgg',))\n"
        "def step(params, cfg=None):\n"
        "    return params\n"),
}


@pytest.mark.parametrize("rule", list(NO_COUNTERPART))
def test_rules_without_counterpart_fire_in_jax_only(rule):
    src = NO_COUNTERPART[rule]
    assert rule in {r for r, _ in jax(src)}
    assert rule not in {r for r, _ in port(src)}
    assert findings.RULES[rule].not_flagged


def test_registry_equals_jax_row_for_row():
    """Ids, names and severities equal JAX's for every rule; a summary
    differs only where the rule is retargeted; every rule the port does
    not flag says why, and only those."""
    assert list(findings.RULES) == list(jax_findings.RULES)
    reworded = set()
    for rid, rule in jax_findings.RULES.items():
        mine = findings.RULES[rid]
        assert (mine.id, mine.name, mine.severity) == (
            rule.id, rule.name, rule.severity)
        if mine.summary != rule.summary:
            reworded.add(rid)
    assert reworded == {"RLT201", "RLT202", "RLT204", "RLT304", "RLT402",
                        "RLT502"}
    unflagged = {rid for rid, r in findings.RULES.items() if r.not_flagged}
    assert unflagged == {"RLT106", "RLT203", "RLT205"}
    # the graph walks' rules are flagged by tracecheck and numcheck
    for rid in ("RLT301", "RLT302", "RLT303", "RLT305", "RLT306",
                "RLT307", "RLT308", "RLT801", "RLT802", "RLT803",
                "RLT804", "RLT805"):
        assert findings.RULES[rid].not_flagged is None, rid
    assert findings.SEVERITY_RANK == jax_findings.SEVERITY_RANK
    assert findings.TRACED_STEP_HOOKS == jax_findings.TRACED_STEP_HOOKS
    f = findings.Finding("RLT201", "m", file="a.py", line=3, symbol="s")
    g = jax_findings.Finding("RLT201", "m", file="a.py", line=3, symbol="s")
    assert f.to_dict()["severity"] == g.to_dict()["severity"] == "error"
    assert f.format().split(" (")[0] == g.format().split(" (")[0]
    assert findings.meets([f], "error") and not findings.meets([], "note")


# ---- the package lints clean ---------------------------------------------------


@pytest.fixture(scope="module")
def package_findings():
    return lint_paths([PKG])


def test_port_package_lints_clean(package_findings):
    """The bar the JAX package holds itself to
    (`tests/test_analysis_lint.py::test_whole_package_self_lint_clean`),
    for the port, under the retargeted rules."""
    assert package_findings == [], "\n".join(
        f.format() for f in package_findings)
