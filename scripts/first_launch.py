"""How long a fresh process's first flash launch takes on the card, alone
and beside other processes.

Each case starts fresh processes that each create their CUDA context,
load the flash libraries (`ops.build.load`), then time their first flash
forward and backward at a small shape, and a second forward at another
shape. The cases:

  alone      — one process, the card otherwise idle;
  pair       — two processes at once, as two gloo ranks start on one card;
  beside     — one process while another holds a CUDA context, idle,
               after its own first flash call;
  pair_eager — two processes at once under ``CUDA_MODULE_LOADING=EAGER``.

One JSON line per process: the case, its seconds by part. Builds the
flash sources first (from the checkout).

Run from the repo root on a machine with the card:
    python3 scripts/first_launch.py

``--cpu`` times instead, in a fresh process on CPU tensors, the first
and second calls of the ``rltt::flash_fwd`` custom op (its plain
version there) and counts the modules its first call imports.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(case: str, hold: float) -> None:
    """One process of ``case``: the parts' seconds as a JSON line; then,
    with ``hold``, keep the context that long."""
    import torch

    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels import flash as F

    parts, t0 = {}, time.perf_counter()

    def part(name):
        nonlocal t0
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    x = torch.randn(1, 128, 2, 128, device="cuda").to(torch.bfloat16)
    part("cuda")
    for name in ("flash_fwd", "flash_bwd"):
        build.load(name)
    part("load")
    q, k, v = (x.clone().requires_grad_() for _ in range(3))
    o = F.flash_attention_kernel(q, k, v, causal=True)
    part("first_fwd")
    o.backward(x)
    part("first_bwd")
    y = torch.randn(2, 1024, 8, 128, device="cuda").to(torch.bfloat16)
    F.flash_fwd_kernel(y, y, y, False, 0)
    part("second_fwd")
    print(json.dumps(dict(case=case, pid=os.getpid(), parts_s=parts)),
          flush=True)
    if hold:
        time.sleep(hold)


def spawn(case: str, n: int, env=None, hold: float = 0.0) -> list:
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r}); "
            f"import first_launch; first_launch.child({case!r}, {hold})")
    return [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                             env={**os.environ, **(env or {})})
            for _ in range(n)]


def wait(procs) -> None:
    for p in procs:
        p.wait(timeout=300)
        if p.returncode:
            raise SystemExit(f"a probe process failed (rc {p.returncode})")


def cpu_child() -> None:
    """The custom op's first and second calls on CPU tensors, and the
    modules the first imports (JSON)."""
    import torch

    from ray_lightning_tpu_torch.ops.kernels import flash as F

    x = torch.randn(1, 128, 2, 128).to(torch.bfloat16)
    before = set(sys.modules)
    out = {}
    for call in ("first", "second"):
        t0 = time.perf_counter()
        F.flash_fwd_op(x, x, x, True, 0, 128 ** -0.5)
        out[f"{call}_call_s"] = time.perf_counter() - t0
    new = set(sys.modules) - before
    out["modules_imported"] = len(new)
    out["packages"] = sorted({".".join(m.split(".")[:2]) for m in new
                              if m.startswith(("torch", "sympy"))})
    print(json.dumps(dict(case="cpu", **out)), flush=True)


def main() -> int:
    if "--cpu" in sys.argv[1:]:
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
                f"sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r}); "
                "import first_launch; first_launch.cpu_child()")
        return subprocess.run([sys.executable, "-c", code],
                              cwd=ROOT).returncode
    sys.path.insert(0, ROOT)
    from ray_lightning_tpu_torch.ops import build

    build.build_all(["flash_fwd", "flash_bwd"])
    wait(spawn("alone", 1))
    wait(spawn("pair", 2))
    holder = spawn("holder", 1, hold=60.0)
    time.sleep(20.0)  # the holder's context and first call are done
    wait(spawn("beside", 1))
    for p in holder:
        p.kill()
        p.wait()
    wait(spawn("pair_eager", 2, env={"CUDA_MODULE_LOADING": "EAGER"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
