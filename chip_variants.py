#!/usr/bin/env python3
"""Time variants of the paged decode and RMSNorm kernels on one CUDA card.

Each variant is a set of textual changes to one kernel source, made in a
copy of ``ray_lightning_tpu_torch/ops/csrc`` under
``ray_lightning_tpu_torch/ops/build/variants/<kernel> <variant>/``
(git-ignored), built there and called through the same C entry point as
the kernel's wrapper; the sources themselves are never touched. The
decode variants may also change R, the blocks of each (slot, KV head)
cluster. Every decode copy gets one more C function, `decode_max_clusters`,
which asks the card how many clusters of R blocks it holds at once.

For each decode variant: the time at chip_smoke's serving shape (lengths
4096 / 1537 / 700 / 33) and at two near-empty ones (one visible position
a slot; none), cold (chip_smoke's ``time_ms``: L2 flushed, the card busy
before the call) and warm (``torch.profiler`` over back-to-back calls, the
kernel's own device time); the worst share of chip_smoke's tolerance where
the variant still computes the output; and the clusters the card holds.
For each RMSNorm variant: the cold time at chip_smoke's RMS_CASES and the
share of the tolerance. One JSON line per variant and shape. Exits
nonzero if a variant fails to build or one that computes the output
breaks the tolerance.

Run from the repository root: ``python3 chip_variants.py`` (about two
minutes on one H100).
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

import chip_smoke as smoke

_TILE = ("    w.tile(sk, sk + D::kKVBytes / 2, (t_lo + i) * D::kTile + 16 * warp,"
         " lo, scale_log2, lane);\n")
_W_EARLY = "      load_w(wv[k], wb + (int64_t)i * VEC, w_vec);\n    }\n  }\n  float ss"
_W_USE = ("      Pack<TX, VEC> y;\n#pragma unroll\n      for (int e = 0; e < VEC; ++e)"
          " y.v[e] = from_f<TX>(to_f(xv[k].v[e])")
#: decode variant -> (text patches of paged_attention.cu, R or None for the
#: wrapper's plan, whether the output is still computed)
DECODE = {
    "as built": ([], None, True),
    "3 stages": ([("kStages = 2;", "kStages = 3;")], None, True),
    "R 16": ([], 16, True),
    "R 4": ([], 4, True),
    "no products": ([(_TILE, "")], None, False),
    "no walk": ([("n_tiles = run.y - run.x;", "n_tiles = 0 * (run.y - run.x);")],
                None, False),
}
#: RMSNorm variant -> text patches of rmsnorm.cu
RMS = {
    "as built": [],
    "w after the sum": [(_W_EARLY, "    }\n  }\n  float ss"),
                        (_W_USE, "      load_w(wv[k], wb + (int64_t)i * VEC, w_vec);\n"
                                 + _W_USE)],
    "1 vector a thread": [("constexpr int kPer = 2;", "constexpr int kPer = 1;")],
    "4 vectors a thread": [("constexpr int kPer = 2;", "constexpr int kPer = 4;")],
}
SOURCE = {"decode": "paged_attention.cu", "rms": "rmsnorm.cu"}
#: appended to every decode copy: clusters of R blocks the card holds at once
PROBE = """
extern "C" int decode_max_clusters(int R) {
  using D = Decode<128>;
  cudaFuncSetAttribute(decode_cluster<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kSmem);
  cudaFuncSetAttribute(decode_cluster<128>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, 1, 1);
  cfg.blockDim = dim3(D::kThreads);
  cfg.dynamicSmemBytes = D::kSmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, decode_cluster<128>, &cfg) == cudaSuccess ? n : -1;
}
"""
#: decode shapes: name -> (lengths, pads) over chip_smoke's serving pool
CASES = {"serving": (smoke.DECODE_LENGTHS, (0, 0, 0, 0)),
         "one position a slot": ((1, 4096, 2, 1), (0, 4095, 1, 0)),
         "nothing visible": ((0, 0, 0, 0), (0, 0, 0, 0))}


def patched(kind: str, name: str, patches) -> str:
    """The text of the kernel source with ``patches`` made (each text must
    occur once)."""
    from ray_lightning_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, SOURCE[kind])) as f:
        code = f.read()
    for old, new in patches:
        if code.count(old) != 1:
            raise RuntimeError(f"{kind} {name}: {old!r} is not in "
                               f"{SOURCE[kind]} once")
        code = code.replace(old, new)
    return code


def build_all():
    """Start one nvcc per variant, all at once; {(kind, name): CDLL}."""
    from ray_lightning_tpu_torch.ops import build

    jobs = []
    tables = [("decode", n, v[0]) for n, v in DECODE.items()] + \
        [("rms", n, p) for n, p in RMS.items()]
    for kind, name, patches in tables:
        d = os.path.join(build.BUILD, "variants", f"{kind} {name}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        code = patched(kind, name, patches) + (PROBE if kind == "decode" else "")
        src = os.path.join(d, SOURCE[kind])
        with open(src, "w") as f:
            f.write(code)
        out = os.path.join(d, "lib.so")
        jobs.append((kind, name, out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, failed = {}, []
    for kind, name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{kind} {name}:\n{log}")
            continue
        libs[(kind, name)] = ctypes.CDLL(out)
    if failed:
        raise RuntimeError("variant builds failed:\n" + "\n".join(failed))
    return libs


def decode_call(lib, args, kw, ranges):
    """A call of ``lib``'s decode entry point as the wrapper makes it."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels import paged_attention as pa

    fn = lib.paged_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q, pool_k, pool_v, tables, lengths = args
    c, h, hd = q.shape
    _, p, hkv, _ = pool_k.shape
    m = tables.shape[1]
    r = ranges or pa.decode_plan(c, hkv, m * p, pa.sm_count(0))
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, pool_k, pool_v, tables, lengths,
                                   kw["pad"], out)]

    def call():
        build.check(fn(*ptrs, c, h, hkv, hd, p, m, r, hd ** -0.5,
                       torch.cuda.current_stream().cuda_stream), "variant")
        return out
    return call, r


def rms_call(lib, x, w):
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels import rmsnorm as rn

    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)

    def call():
        build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
                       x.shape[1], rn._DTYPES[x.dtype], rn._DTYPES[w.dtype],
                       1e-5, torch.cuda.current_stream().cuda_stream),
                    "variant")
        return out
    return call


def main() -> int:
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_plain)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_plain

    if not torch.cuda.is_available():
        smoke.log("chip_variants: no CUDA device available")
        return 1
    print(smoke.nvidia_smi(), flush=True)
    libs = build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    inp = smoke.KernelInputs(gen)
    bad = []
    for case, (lengths, pad) in CASES.items():
        args, kw = inp.decode(lengths, pad)
        want = paged_attention_plain(*args, **kw)
        for name, (_, ranges, computes) in DECODE.items():
            lib = libs[("decode", name)]
            call, r = decode_call(lib, args, kw, ranges)
            share = smoke.tolerance_ratio(call(), want)[1] if computes else None
            if computes and not share <= 1.0:
                bad.append(f"decode {name} {case}: share {share}")
            lib.decode_max_clusters.restype = ctypes.c_int
            print(json.dumps(dict(
                kernel="paged_decode", variant=name, case=case, R=r,
                tolerance_share=share, cold_ms=smoke.time_ms(call),
                warm_ms=sum(k["ms"] for k in
                            smoke.kernel_profile(call, 50).values()),
                max_clusters=lib.decode_max_clusters(r))), flush=True)
    for n, d, wdt in smoke.RMS_CASES:
        x, w = smoke.rms_inputs(gen, n, d, wdt)
        want = rms_norm_plain(x, w)
        for name in RMS:
            call = rms_call(libs[("rms", name)], x, w)
            share = smoke.tolerance_ratio(call(), want)[1]
            if not share <= 1.0:
                bad.append(f"rms_norm {name} N={n} D={d}: share {share}")
            print(json.dumps(dict(
                kernel="rms_norm", variant=name, N=n, D=d,
                w=str(wdt).split(".")[-1], tolerance_share=share,
                cold_ms=smoke.time_ms(call))), flush=True)
    if bad:
        smoke.log("chip_variants: " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
