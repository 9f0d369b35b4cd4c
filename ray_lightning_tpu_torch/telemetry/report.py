"""``python -m ray_lightning_tpu_torch report|monitor`` — the measured
side of a telemetry-enabled run (twin of
`ray_lightning_tpu/telemetry/report.py`; it reads either package's
files).

``report <run_dir>`` reads the per-rank span JSONL + goodput ledgers a
telemetry-enabled run left under ``<run_dir>/telemetry`` and prints:

  * the goodput classification (telemetry/goodput.py buckets, summing
    to supervised wall time),
  * per-rank phase totals and warm-window step-time stats,
  * for serving runs, an SLO section: TTFT/TPOT/queue-wait p50/p95/p99
    from the exactly-merged histogram buckets with the bucket sketch
    printed (tails are auditable), event counters, a per-replica
    timeline with restart markers, and the load-signal summary,
  * the incident ledger's summary, and which evidence streams the run
    dir holds and which it lacks.

``--preset`` asks for the DRIFT section, which joins the measured step
against a static prediction. The prediction needs the JAX package's
tracecheck cost model, which is not ported (ROADMAP Queue 1 item 13),
so the section carries the structured "prediction unavailable" flag
beside the measured step — never a guessed number.

``monitor <run_dir>`` is the live view: last span + current phase per
rank and the partial goodput, one shot (or ``--follow``).
``monitor <run_dir> --serve [--follow]`` renders the live SERVING tick
stream instead — per-replica queue depth, decoding/prefilling slots,
pool headroom, decode token rate, preemption/growth-stall counters,
and the load signal, read from the per-tick metrics JSONL
(telemetry/metrics.py).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.telemetry import goodput as gp
from ray_lightning_tpu_torch.telemetry.spans import PH_STEP, read_spans

#: |measured/predicted - 1| beyond this flags drift
DRIFT_THRESHOLD = 0.25

#: the autoscale controller's decision ledger, beside the telemetry dir
AUTOSCALE_LEDGER = "autoscale.jsonl"
RESHARD_LEDGER = "reshards.jsonl"

#: where the drift section's prediction would come from
DRIFT_UNAVAILABLE = ("the static step prediction needs analysis/"
                     "tracecheck, not ported (ROADMAP Queue 1 item 13)")


# ---------------------------------------------------------------- timeline


def telemetry_dir(run_dir: str) -> str:
    """Accept either the run dir or the telemetry dir itself."""
    if glob.glob(os.path.join(run_dir, "rank*.spans.jsonl")):
        return run_dir
    return os.path.join(run_dir, "telemetry")


def load_timeline(run_dir: str,
                  tail_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Assemble the clock-aligned cross-rank view from the span files.
    Restarted attempts leave one pid-tagged file each per rank — they
    are merged in wall-clock order (totals accumulate; the "current"
    phase comes from the newest attempt). ``tail_bytes`` bounds each
    file's read — the cadence-polled `monitor --follow` path threads a
    bound here; the one-shot report reads everything."""
    tdir = telemetry_dir(run_dir)
    ranks: Dict[int, Dict[str, Any]] = {}
    paths = sorted(glob.glob(os.path.join(tdir, "rank*.spans.jsonl")))
    parsed_files = []
    for path in paths:
        parsed = read_spans(path, tail_bytes=tail_bytes)
        rank = int(parsed["header"].get("rank", -1)) \
            if parsed["header"] else -1
        t0 = (parsed["header"] or {}).get("t0_wall") or 0.0
        parsed_files.append((rank, t0, path, parsed))
    parsed_files.sort(key=lambda e: (e[0], e[1]))
    for rank, t0, path, parsed in parsed_files:
        info = ranks.setdefault(rank, {
            "paths": [], "t0_wall": None, "phase_totals": {},
            "phase_counts": {}, "step_durs": [], "last_span": None,
            "dropped": 0, "attempts": 0,
        })
        info["paths"].append(path)
        info["attempts"] += 1
        info["t0_wall"] = t0  # newest attempt wins (sorted ascending)
        for span in parsed["spans"]:
            phase = span.get("phase", "?")
            if span.get("thread", "main") == "main":
                # "excl" is the nested-exclusive charge the recorder
                # persisted — summing raw durs would double-count a
                # compile inside an eval span
                info["phase_totals"][phase] = (
                    info["phase_totals"].get(phase, 0.0)
                    + float(span.get("excl", span.get("dur", 0.0))))
                info["phase_counts"][phase] = (
                    info["phase_counts"].get(phase, 0) + 1)
            if phase == PH_STEP:
                info["step_durs"].append(float(span.get("dur", 0.0)))
            info["last_span"] = span
        info["dropped"] += parsed["dropped"]
    return {"telemetry_dir": tdir, "ranks": ranks,
            "step_stats": _step_stats(ranks)}


def _step_stats(ranks: Dict[int, Dict[str, Any]]) -> Optional[dict]:
    """Warm-window step-time stats over rank 0's per-step spans; the
    first interval (cold step: lazy compile, cache population) is
    dropped — same convention as ThroughputMonitor."""
    r0 = ranks.get(0) or (next(iter(ranks.values())) if ranks else None)
    if not r0:
        return None
    durs = r0["step_durs"][1:] if len(r0["step_durs"]) > 1 \
        else r0["step_durs"]
    if not durs:
        return None
    durs = sorted(durs)
    return {
        "steps": len(durs),
        "mean_s": sum(durs) / len(durs),
        "p50_s": durs[len(durs) // 2],
        "max_s": durs[-1],
    }


# ------------------------------------------------------------------ drift


def build_drift(predicted: Dict[str, Any],
                timeline: Optional[Dict[str, Any]],
                threshold: float = DRIFT_THRESHOLD) -> Dict[str, Any]:
    """Join measured vs predicted; flags name what disagrees. With no
    measured spans the measured slot is the structured-skip placeholder
    — same keys, null values, a "skipped" reason — never a missing
    section."""
    drift: Dict[str, Any] = {"predicted": predicted, "threshold": threshold}
    stats = (timeline or {}).get("step_stats")
    if not stats:
        drift["measured"] = {
            "step_us": None, "steps": 0,
            "skipped": "no measured telemetry spans (backend down, "
                       "telemetry off, or the run never stepped)",
        }
        drift["flags"] = []
        drift["verdict"] = "not-measured"
        return drift
    # p50, not mean: a step span that crosses an epoch boundary carries
    # the eval epoch + checkpoint inside its interval and would skew a
    # mean by orders of magnitude; the median is the honest per-step
    # wall (the boundary outliers are already itemized as eval/ckpt
    # spans in their own right)
    measured_us = stats["p50_s"] * 1e6
    drift["measured"] = {"step_us": round(measured_us, 1),
                         "steps": stats["steps"],
                         "mean_us": round(stats["mean_s"] * 1e6, 1)}
    flags: List[str] = []
    pred_us = predicted.get("step_us")
    if pred_us:
        ratio = measured_us / pred_us
        drift["step_time_ratio"] = round(ratio, 3)
        if abs(ratio - 1.0) > threshold:
            direction = "slower" if ratio > 1 else "faster"
            flags.append(
                f"measured step {measured_us / 1e3:.2f} ms is "
                f"{ratio:.2f}x the modeled compute+exposed-ICI floor "
                f"({pred_us / 1e3:.2f} ms) — {direction} than the cost "
                "model beyond the threshold; the static "
                "overlap_hidden_fraction "
                f"({predicted.get('overlap_hidden_fraction')}) may not "
                "be realized on this hardware")
    elif predicted.get("error"):
        flags.append(f"prediction unavailable: {predicted['error']}")
    else:
        flags.append("cost model produced no compute window for this "
                     "step (no scanned scopes); only ICI time was "
                     "predicted — step-time drift not judged")
    drift["flags"] = flags
    drift["verdict"] = "drift" if (pred_us and flags) else "ok" \
        if pred_us else "partial-model"
    return drift


# ------------------------------------------------------------------ report


def add_report_parser(sub) -> None:
    p = sub.add_parser(
        "report",
        help="goodput + span-timeline report for a telemetry-enabled "
             "run dir (docs/OBSERVABILITY.md)")
    p.add_argument("run_dir",
                   help="run dir (or its telemetry/ subdir) holding "
                        "rank*.spans.jsonl / goodput ledgers")
    p.add_argument("--preset", default=None,
                   help="ask for the drift section (measured step against "
                        "a static prediction; the prediction is not "
                        "ported, so the section says so)")
    p.add_argument("--drift-threshold", type=float,
                   default=DRIFT_THRESHOLD)
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def _pct(sorted_vals, q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


def build_serving_section(run_dir: str) -> Optional[Dict[str, Any]]:
    """Per-request serving latency attribution when this run dir holds
    serving telemetry (either package's serve driver): TTFT/TPOT
    percentiles from the per-request decode spans (or the driver's serving.json summary) +
    replica restarts + aggregate throughput. When the run recorded
    LIVE metrics (telemetry/metrics.py), the section grows the SLO
    view: p99s computed from the exactly-merged histogram buckets, the
    bucket sketches so tails are auditable, preemption / growth-stall
    counts, queue-depth stats, the per-replica timeline (restart
    markers = extra metrics files per replica), and the autoscale load
    signal. None when the run served nothing — training runs keep
    their report unchanged."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        aggregate_from_parsed, load_signal_from_parsed,
        newest_from_parsed, read_all_metrics,
    )
    from ray_lightning_tpu_torch.telemetry.spans import PH_DECODE, read_spans

    tdir = telemetry_dir(run_dir)
    base = run_dir if tdir != run_dir else os.path.dirname(run_dir)
    summary = None
    spath = os.path.join(base, "serving.json")
    if os.path.exists(spath):
        try:
            with open(spath) as f:
                summary = json.load(f)
        except (OSError, json.JSONDecodeError):
            summary = None
    per_req: Dict[str, dict] = dict((summary or {}).get("meta", {}))
    if not per_req:
        # fall back to the span files: decode spans carry the request
        # meta (rid, ttft_s, tpot_s) at completion. Replayed-prefix and
        # inflight-tagged spans carry neither ttft_s nor tpot_s, so a
        # preempted request's discarded prefix can never double-count
        # into the latency percentiles here.
        for path in sorted(glob.glob(
                os.path.join(tdir, "rank*.spans.jsonl"))):
            try:
                parsed = read_spans(path)
            except OSError:
                continue
            for span in parsed["spans"]:
                meta = span.get("meta") or {}
                if span.get("phase") == PH_DECODE and "ttft_s" in meta:
                    per_req[meta.get("rid", f"?{len(per_req)}")] = meta
    parsed_metrics = read_all_metrics(tdir)  # ONE parse pass for both
    metrics_agg = aggregate_from_parsed(parsed_metrics)
    if not per_req and not metrics_agg:
        return None
    section: Dict[str, Any] = {"requests": len(per_req)}
    if per_req:
        ttfts = sorted(float(m.get("ttft_s", 0.0))
                       for m in per_req.values())
        tpots = sorted(float(m.get("tpot_s", 0.0))
                       for m in per_req.values())
        section.update({
            "ttft_p50_s": round(_pct(ttfts, 0.50), 4),
            "ttft_p95_s": round(_pct(ttfts, 0.95), 4),
            "tpot_p50_s": round(_pct(tpots, 0.50), 4),
            "tpot_p95_s": round(_pct(tpots, 0.95), 4),
        })
    if summary:
        stats = summary.get("stats", {})
        for key in ("decode_tokens_per_s", "slot_occupancy",
                    "warmup_cold_s", "warmup_respawn_s"):
            if stats.get(key) is not None:
                section[key] = stats[key]
        restarts = summary.get("restarts", {})
        if restarts:
            section["replica_restarts"] = restarts
    if metrics_agg:
        lat = metrics_agg.get("latency") or {}
        for name, key in (("ttft_s", "ttft"), ("tpot_s", "tpot"),
                          ("queue_wait_s", "queue_wait")):
            block = lat.get(name)
            if not block:
                continue
            # bucket-derived quantiles override the sample-derived
            # p50/p95 when present: they merge exactly across replicas
            # and attempts, and they come with an auditable sketch
            section[f"{key}_p50_s"] = block["p50"]
            section[f"{key}_p95_s"] = block["p95"]
            section[f"{key}_p99_s"] = block["p99"]
            section[f"{key}_sketch"] = block["sketch"]
            section[f"{key}_n"] = block["n"]
        counters = metrics_agg.get("counters") or {}
        section["counters"] = counters
        if "queue_depth" in metrics_agg:
            section["queue_depth"] = metrics_agg["queue_depth"]
        # restart markers: each respawned attempt opened its own
        # uid-tagged metrics file, so files - 1 = restarts observed
        section["timeline"] = {
            rep: {"attempts": info["files"],
                  "restart_markers": info["files"] - 1,
                  "ticks": info["ticks"],
                  "last_tick_t": info["last_tick_t"]}
            for rep, info in sorted(
                (metrics_agg.get("replicas") or {}).items())}
        section["load_signal"] = load_signal_from_parsed(
            newest_from_parsed(parsed_metrics), where=tdir)
    autoscale = build_autoscale_section(base, tdir)
    if autoscale:
        section["autoscale"] = autoscale
    return section


def read_autoscale_ledger(run_dir: str,
                          tail_bytes: Optional[int] = None) -> List[dict]:
    """The entries of ``<run_dir>/autoscale.jsonl`` (the ledger that
    `autoscale.controller.AutoscaleController` writes, in the JAX
    package's format: either package's ledger reads here). A missing
    file is no decisions; unparseable lines are skipped; the
    clock-alignment header line is not an entry."""
    from ray_lightning_tpu_torch.telemetry.spans import ledger_tail_lines

    out: List[dict] = []
    try:
        first, body = ledger_tail_lines(
            os.path.join(run_dir, AUTOSCALE_LEDGER), tail_bytes)
    except OSError:
        return out
    for line in [first] + body:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(obj, dict):
            continue
        if "version" in obj and "decision" not in obj:
            continue  # the clock-alignment header
        out.append(obj)
    return out


def build_autoscale_section(base: str, tdir: str,
                            tail_bytes: Optional[int] = None
                            ) -> Optional[Dict[str, Any]]:
    """The controller's decision ledger, summarized
    (``<run_dir>/autoscale.jsonl``, docs/AUTOSCALE.md): decision/event
    counts, spawn retries, the final replica count, the last decision
    with its reason, plus the driver-stream scale/deferral counters
    (``driver*.metrics.jsonl``). None when the run never ran a
    controller — plain serving reports stay unchanged."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        driver_metrics_paths, read_metrics,
    )

    entries = read_autoscale_ledger(base, tail_bytes=tail_bytes)
    if not entries:
        return None

    def _acted(e: dict) -> bool:
        # an event is anything that CHANGED the replica set — a partial
        # scale-up (outcome.ok False but replicas added before the
        # budget ran out) must still show in the timeline, or the
        # report would contradict final_replicas
        out = e.get("outcome") or {}
        return bool(out.get("added") or out.get("removed"))

    events = [e for e in entries if _acted(e)]
    last = entries[-1]
    section: Dict[str, Any] = {
        "decisions": len(entries),
        "scale_ups": sum(1 for e in events
                         if e["decision"]["action"] == "scale_up"),
        "scale_downs": sum(1 for e in events
                           if e["decision"]["action"] == "scale_down"),
        "spawn_retries": sum(
            int((e.get("outcome") or {}).get("retries") or 0)
            for e in entries),
        "final_replicas": last.get("replicas"),
        "last_decision": {
            "now": last.get("now"),
            **(last.get("decision") or {}),
        },
        "events": [{"now": e.get("now"),
                    "action": e["decision"]["action"],
                    "target": e["decision"]["target"],
                    **({} if (e.get("outcome") or {}).get("ok")
                       else {"partial": True})}
                   for e in events],
    }
    counters: Dict[str, int] = {}
    for path in driver_metrics_paths(tdir):
        try:
            parsed = read_metrics(path, tail_bytes=tail_bytes)
        except OSError:
            continue
        for name, v in parsed["counters"].items():
            counters[name] = counters.get(name, 0) + int(v)
    if counters:
        section["driver_counters"] = counters
        if "submit_deferrals" in counters:
            section["submit_deferrals"] = counters["submit_deferrals"]
    return section


#: evidence stream name -> (where, glob/file) — the detection table the
#: structured partial report names missing streams from. A run dir
#: that holds only a SUBSET (a run killed before the first span flush,
#: an autoscale-only dir) degrades to a partial report naming the gap,
#: never a traceback (test-pinned, docs/OBSERVABILITY.md).
EVIDENCE_STREAMS = (
    ("spans", "telemetry", "rank*.spans.jsonl"),
    ("goodput", "telemetry", "goodput.json"),
    ("metrics", "telemetry", "*.metrics.jsonl"),
    ("flight", "both", "*flight.json"),
    ("autoscale", "run", "autoscale.jsonl"),
    ("reshard", "both", "reshards.jsonl"),
    ("incidents", "run", "incidents.jsonl"),
    ("serving", "run", "serving.json"),
)


def detect_streams(run_dir: str, tdir: str) -> Dict[str, List[str]]:
    """Which evidence streams this run dir actually holds — the
    report's honesty header: a partial report SAYS what is missing
    instead of silently rendering empty sections."""
    base = run_dir if tdir != run_dir else os.path.dirname(run_dir)
    present: List[str] = []
    missing: List[str] = []
    for name, where, pattern in EVIDENCE_STREAMS:
        dirs = {"telemetry": (tdir,), "run": (base,),
                "both": (base, tdir)}[where]
        found = any(glob.glob(os.path.join(d, pattern)) for d in dirs)
        (present if found else missing).append(name)
    return {"present": present, "missing": missing}


def build_incidents_section(run_dir: str,
                            tail_bytes: Optional[int] = None
                            ) -> Optional[Dict[str, Any]]:
    """The incident ledger, summarized (telemetry/incidents.py,
    docs/OBSERVABILITY.md "watch rules & incidents"). None when the
    run never ran a watch (or nothing fired and no ledger exists)."""
    from ray_lightning_tpu_torch.telemetry.incidents import read_incidents

    tdir = telemetry_dir(run_dir)
    base = run_dir if tdir != run_dir else os.path.dirname(run_dir)
    parsed = read_incidents(base, tail_bytes=tail_bytes)
    if not parsed["incidents"] and not parsed["header"]:
        return None
    by_rule: Dict[str, int] = {}
    by_sev: Dict[str, int] = {}
    for inc in parsed["incidents"]:
        by_rule[inc.get("rule", "?")] = \
            by_rule.get(inc.get("rule", "?"), 0) + 1
        by_sev[inc.get("severity", "?")] = \
            by_sev.get(inc.get("severity", "?"), 0) + 1
    section: Dict[str, Any] = {
        "count": len(parsed["incidents"]),
        "by_rule": by_rule,
        "by_severity": by_sev,
        "unparseable_lines": parsed["unparseable_lines"],
    }
    if parsed["incidents"]:
        last = parsed["incidents"][-1]
        section["last"] = {
            "rule": last.get("rule"),
            "severity": last.get("severity"),
            "wall": last.get("wall"),
            "evidence": {k: (last.get("evidence") or {}).get(k)
                         for k in ("metric", "value", "op",
                                   "threshold")},
            "actions": sorted(last.get("actions") or {}),
            "excerpt_events": len(last.get("timeline_excerpt") or []),
        }
    return section


def build_reshard_section(run_dir: str,
                          tail_bytes: Optional[int] = None
                          ) -> Optional[Dict[str, Any]]:
    """The elastic supervisor's reshard ledger, summarized
    (``<run_dir>/reshards.jsonl``, `resilience.supervisor`; the JAX
    package's file, so either package's ledger reads here): the world
    changes, the grows the capacity oracle refused (with its answer and
    source), and the final world. None when the run never changed
    world or asked to."""
    from ray_lightning_tpu_torch.telemetry.spans import ledger_tail_lines

    tdir = telemetry_dir(run_dir)
    base = run_dir if tdir != run_dir else os.path.dirname(run_dir)
    try:
        first, body = ledger_tail_lines(
            os.path.join(base, RESHARD_LEDGER), tail_bytes)
    except OSError:
        return None
    entries = []
    for line in [first] + body:
        try:
            obj = json.loads(line)
        except (json.JSONDecodeError, TypeError):
            continue
        if isinstance(obj, dict) and "reason" in obj:
            entries.append(obj)
    if not entries:
        return None
    keep = ("from_world", "to_world", "reason", "attempt")
    changes = [{k: e[k] for k in keep if k in e} for e in entries
               if e["reason"] in ("shrink", "grow")]
    refused = [{k: e[k] for k in ("from_world", "resolved_max", "capacity",
                                  "capacity_source", "attempt") if k in e}
               for e in entries if e["reason"] == "grow_refused"]
    return {"changes": changes, "grow_refused": refused,
            "final_world": changes[-1]["to_world"] if changes else None}


def build_report(run_dir: str, preset: Optional[str] = None,
                 threshold: float = DRIFT_THRESHOLD) -> Dict[str, Any]:
    timeline = load_timeline(run_dir)
    out: Dict[str, Any] = {
        "run_dir": run_dir,
        "telemetry_dir": timeline["telemetry_dir"],
        "ranks": sorted(timeline["ranks"]),
        "step_stats": timeline["step_stats"],
        "phase_totals": {
            str(r): v["phase_totals"]
            for r, v in sorted(timeline["ranks"].items())},
        "goodput": gp.read_goodput(timeline["telemetry_dir"]),
        "streams": detect_streams(run_dir, timeline["telemetry_dir"]),
    }
    serving = build_serving_section(run_dir)
    if serving:
        out["serving"] = serving
    incidents = build_incidents_section(run_dir)
    if incidents:
        out["incidents"] = incidents
    reshards = build_reshard_section(run_dir)
    if reshards:
        out["reshards"] = reshards
    if preset:
        out["drift"] = build_drift(
            {"label": preset, "error": DRIFT_UNAVAILABLE}, timeline,
            threshold)
    return out


def _print_report(out: Dict[str, Any]) -> None:
    print(f"telemetry report: {out['run_dir']}")
    streams = out.get("streams") or {}
    if streams:
        missing = streams.get("missing") or []
        print(f"streams: {', '.join(streams.get('present') or ['none'])}"
              + (f" (missing: {', '.join(missing)})" if missing
                 else ""))
    rs = out.get("reshards")
    if rs:
        moves = ", ".join(f"{c['reason']} {c.get('from_world')}->"
                          f"{c.get('to_world')}" for c in rs["changes"])
        print(f"reshards: {moves or 'none'}; final world "
              f"{rs['final_world']}")
        for r in rs["grow_refused"]:
            print(f"  grow_refused {r.get('from_world')}->"
                  f"{r.get('resolved_max')}: capacity {r.get('capacity')} "
                  f"({r.get('capacity_source')})")
    inc = out.get("incidents")
    if inc:
        by_rule = ", ".join(f"{r}x{n}" for r, n in
                            sorted(inc["by_rule"].items()))
        print(f"incidents: {inc['count']} ({by_rule})")
        last = inc.get("last") or {}
        if last:
            ev = last.get("evidence") or {}
            print(f"  last: [{last.get('severity')}] "
                  f"{last.get('rule')} — {ev.get('metric')} = "
                  f"{ev.get('value')} {ev.get('op')} "
                  f"{ev.get('threshold')}; "
                  f"{last.get('excerpt_events')} excerpt event(s), "
                  f"actions: {', '.join(last.get('actions') or []) or 'none'}")
    g = out.get("goodput")
    if g:
        print(f"goodput: {g['goodput_fraction']:.1%} of "
              f"{g['wall_s']:.1f}s wall productive "
              f"({g['events']['restarts']} restart(s), "
              f"{g['events']['preemptions']} preemption(s), "
              f"{g['events']['rollbacks']} rollback(s))")
        for b, v in g["buckets"].items():
            if v:
                print(f"  {b:<20} {v:8.2f}s  "
                      f"{v / g['wall_s']:6.1%}")
    else:
        print("goodput: no assembled goodput.json (run was not "
              "supervised, or is still in flight)")
    sv = out.get("serving")
    if sv:
        if "ttft_p99_s" in sv:
            # the SLO line: quantiles from the exactly-merged histogram
            # buckets (p99 included), auditable against the sketch
            # a run whose requests all ended at their first token
            # observed no TPOT
            tpot = (f", TPOT p50 {sv['tpot_p50_s'] * 1e3:.1f} / p99 "
                    f"{sv['tpot_p99_s'] * 1e3:.1f} ms"
                    if "tpot_p99_s" in sv else ", no TPOT observed")
            print(f"serving: {sv['requests']} request(s), TTFT p50 "
                  f"{sv['ttft_p50_s'] * 1e3:.1f} / p95 "
                  f"{sv['ttft_p95_s'] * 1e3:.1f} / p99 "
                  f"{sv['ttft_p99_s'] * 1e3:.1f} ms{tpot} (from merged "
                  f"buckets, n={sv.get('ttft_n')})")
            for key, label in (("ttft_sketch", "ttft"),
                               ("queue_wait_sketch", "queue_wait")):
                sk = sv.get(key)
                if sk:
                    buckets = " ".join(
                        f"<={le * 1e3:.1f}ms:{c}" for le, c in sk)
                    print(f"  {label} buckets: {buckets}")
        elif "ttft_p50_s" in sv:
            print(f"serving: {sv['requests']} request(s), TTFT p50 "
                  f"{sv['ttft_p50_s'] * 1e3:.1f} ms / p95 "
                  f"{sv['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50 "
                  f"{sv['tpot_p50_s'] * 1e3:.1f} ms")
        else:
            print(f"serving: {sv['requests']} request(s)")
        extras = ", ".join(
            f"{k}={sv[k]}" for k in ("decode_tokens_per_s",
                                     "slot_occupancy",
                                     "replica_restarts") if k in sv)
        if extras:
            print(f"  {extras}")
        counters = sv.get("counters")
        if counters:
            qd = sv.get("queue_depth") or {}
            print(f"  events: admissions={counters.get('admissions', 0)}"
                  f" preemptions={counters.get('preemptions', 0)}"
                  f" growth_stalls={counters.get('growth_stalls', 0)}"
                  f" deferrals={counters.get('admission_deferrals', 0)}"
                  + (f"; queue_depth p50={qd.get('p50')}"
                     f" max={qd.get('max')}" if qd else ""))
        for rep, tl in (sv.get("timeline") or {}).items():
            marker = (f", {tl['restart_markers']} restart(s)"
                      if tl.get("restart_markers") else "")
            print(f"  replica {rep}: {tl['ticks']} tick(s) over "
                  f"{tl['attempts']} attempt(s){marker}")
        sig = sv.get("load_signal")
        if sig and sig.get("available"):
            print(f"  load signal: queue_depth now "
                  f"{sig['queue_depth_now']:.0f} / p50 "
                  f"{sig['queue_depth_p50']:.0f}, occupancy "
                  f"{sig['occupancy']:.2f}, pressure "
                  f"{sig['pressure'] if sig['pressure'] is not None else '—'}")
        asc = sv.get("autoscale")
        if asc:
            print(f"  autoscale: {asc['decisions']} decision(s) -> "
                  f"{asc['scale_ups']} up / {asc['scale_downs']} down"
                  f" ({asc['spawn_retries']} spawn retr{'y' if asc['spawn_retries'] == 1 else 'ies'}), "
                  f"final replicas {asc['final_replicas']}")
            for e in asc.get("events") or []:
                print(f"    t={e['now']:g}: {e['action']} -> "
                      f"{e['target']}")
            ld = asc.get("last_decision") or {}
            if ld.get("reason"):
                print(f"    last: {ld.get('action')} — "
                      f"{ld['reason']}")
            if asc.get("submit_deferrals"):
                print(f"    submit deferrals: "
                      f"{asc['submit_deferrals']}")
    ss = out.get("step_stats")
    if ss:
        print(f"warm step time: mean {ss['mean_s'] * 1e3:.2f} ms / "
              f"p50 {ss['p50_s'] * 1e3:.2f} ms over {ss['steps']} steps")
    for rank, totals in (out.get("phase_totals") or {}).items():
        hot = ", ".join(f"{k}={v:.2f}s" for k, v in sorted(
            totals.items(), key=lambda kv: -kv[1])[:5])
        print(f"  rank {rank}: {hot or 'no spans'}")
    drift = out.get("drift")
    if drift:
        pred = drift["predicted"]
        print(f"drift vs tracecheck ({pred.get('label', '?')} on "
              f"{pred.get('topology', '?')}):")
        meas = drift["measured"]
        if meas.get("skipped"):
            print(f"  measured: SKIPPED — {meas['skipped']}")
        else:
            print(f"  measured step {meas['step_us'] / 1e3:.2f} ms over "
                  f"{meas['steps']} warm steps")
        if pred.get("step_us"):
            print(f"  predicted step floor "
                  f"{pred['step_us'] / 1e3:.2f} ms (compute "
                  f"{(pred.get('compute_us') or 0) / 1e3:.2f} ms + "
                  f"exposed ICI {pred['ici_exposed_us'] / 1e3:.2f} ms; "
                  f"static overlap_hidden_fraction "
                  f"{pred['overlap_hidden_fraction']})")
        for flag in drift["flags"]:
            print(f"  DRIFT: {flag}")
        print(f"  verdict: {drift['verdict']}")


def run_report(args) -> int:
    if not os.path.isdir(args.run_dir):
        print(f"error: {args.run_dir} is not a directory",
              file=sys.stderr)
        return 2
    out = build_report(args.run_dir, preset=args.preset,
                       threshold=args.drift_threshold)
    if getattr(args, "as_json", False):
        print(json.dumps(out))
    else:
        _print_report(out)
    return 0


# ----------------------------------------------------------------- monitor


def add_monitor_parser(sub) -> None:
    p = sub.add_parser(
        "monitor",
        help="live per-rank phase view of a telemetry-enabled run")
    p.add_argument("run_dir")
    p.add_argument("--follow", action="store_true",
                   help="refresh every --interval seconds until ^C")
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--serve", action="store_true",
                   help="render the live SERVING tick stream instead "
                        "of the training phase view: per-replica queue "
                        "depth, slot/pool state, token rates, and the "
                        "autoscale load signal from the per-tick "
                        "metrics JSONL (docs/OBSERVABILITY.md "
                        "'serving metrics')")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


#: per-ledger read bound for the cadence-polled monitor views — the
#: live view needs the newest spans/ticks, never the whole run history
#: (one-shot `report` still reads everything)
MONITOR_TAIL_BYTES = 1 << 20


def _monitor_once(run_dir: str,
                  tail_bytes: Optional[int] = None) -> Dict[str, Any]:
    timeline = load_timeline(run_dir, tail_bytes=tail_bytes)
    now = time.time()
    view: Dict[str, Any] = {"run_dir": run_dir, "ranks": {}}
    for rank, info in sorted(timeline["ranks"].items()):
        last = info.get("last_span") or {}
        age = None
        if info.get("t0_wall") is not None and last:
            age = now - (info["t0_wall"] + last.get("t", 0.0)
                         + last.get("dur", 0.0))
        view["ranks"][str(rank)] = {
            "phase": last.get("phase"),
            "step": last.get("step"),
            "last_span_age_s": round(age, 1) if age is not None else None,
            "dropped": info["dropped"],
        }
    view["goodput"] = gp.read_goodput(timeline["telemetry_dir"])
    view["step_stats"] = timeline["step_stats"]
    inc = build_incidents_section(run_dir, tail_bytes=tail_bytes)
    if inc:
        view["incidents"] = inc["count"]
    return view


def _monitor_serve_once(run_dir: str,
                        tail_bytes: Optional[int] = None
                        ) -> Dict[str, Any]:
    """One sample of the live serving view: the newest metrics file per
    replica, its latest flushed tick, a token rate over the recent
    window, and the load signal — everything `monitor --serve` renders.
    Reads only flushed JSONL, so the view lags live state by at most
    one flush cadence."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        load_signal_from_parsed, newest_metrics_per_replica,
    )

    tdir = telemetry_dir(run_dir)
    view: Dict[str, Any] = {"run_dir": run_dir, "replicas": {}}
    # ONE parse pass serves both the per-replica view and the load
    # signal — a --follow refresh re-reads each file once, not twice,
    # and reads only each ledger's tail
    newest = newest_metrics_per_replica(tdir, tail_bytes=tail_bytes)
    now = time.time()
    for rep, entry in sorted(newest.items()):
        parsed = entry["parsed"]
        ticks = parsed["ticks"]
        last = ticks[-1] if ticks else {}
        g = dict(last.get("g") or {})
        c = dict(last.get("c") or {})
        rate = None
        if len(ticks) >= 2:
            # decode rate over the flushed window: counter delta / time
            first = ticks[max(0, len(ticks) - 64)]
            dt = float(last.get("t", 0.0)) - float(first.get("t", 0.0))
            dtok = (int((last.get("c") or {}).get("decode_tokens", 0))
                    - int((first.get("c") or {}).get("decode_tokens",
                                                     0)))
            if dt > 0:
                rate = dtok / dt
        age = None
        if ticks and entry["t0"]:
            age = now - (entry["t0"] + float(last.get("t", 0.0)))
        view["replicas"][rep] = {
            "tick": last.get("tick"),
            "age_s": round(age, 1) if age is not None else None,
            "queue_depth": g.get("queue_depth"),
            "decoding": g.get("decoding_slots"),
            "prefilling": g.get("prefilling_slots"),
            "blocks_free": g.get("blocks_free"),
            "decode_tokens_per_s": round(rate, 1) if rate else None,
            "preemptions": c.get("preemptions", 0),
            "growth_stalls": c.get("growth_stalls", 0),
            "compile_count": g.get("compile_count"),
        }
    view["load_signal"] = load_signal_from_parsed(newest, where=tdir)
    base = run_dir if tdir != run_dir else os.path.dirname(run_dir)
    asc = build_autoscale_section(base, tdir, tail_bytes=tail_bytes)
    if asc:
        view["autoscale"] = asc
    inc = build_incidents_section(run_dir, tail_bytes=tail_bytes)
    if inc:
        view["incidents"] = inc["count"]
    return view


def _print_serve_view(view: Dict[str, Any]) -> None:
    print(f"-- {time.strftime('%H:%M:%S')} {view['run_dir']} (serving)")
    for rep, r in view["replicas"].items():
        rate = (f" {r['decode_tokens_per_s']} tok/s"
                if r.get("decode_tokens_per_s") else "")
        print(f"  replica {rep}: tick {r['tick']} "
              f"({r['age_s']}s ago) queue={r['queue_depth']} "
              f"decoding={r['decoding']} prefilling={r['prefilling']} "
              f"blocks_free={r['blocks_free']}{rate} "
              f"preempt={r['preemptions']} "
              f"stalls={r['growth_stalls']}")
    if not view["replicas"]:
        print("  (no metrics files yet)")
    sig = view.get("load_signal") or {}
    if sig.get("available"):
        pressure = sig.get("pressure")
        print(f"  load: queue now {sig['queue_depth_now']:.0f} / p50 "
              f"{sig['queue_depth_p50']:.0f} / max "
              f"{sig['queue_depth_max']:.0f}, occupancy "
              f"{sig['occupancy']:.2f}"
              + (f", pressure {pressure:.2f}"
                 if pressure is not None else ""))
    asc = view.get("autoscale")
    if asc:
        ld = asc.get("last_decision") or {}
        print(f"  autoscale: replicas {asc['final_replicas']}, "
              f"{asc['decisions']} decision(s) "
              f"({asc['scale_ups']} up / {asc['scale_downs']} down); "
              f"last: {ld.get('action')} — "
              f"{(ld.get('reason') or '')[:70]}")
    if view.get("incidents"):
        print(f"  incidents: {view['incidents']} (see `report` / "
              "incidents.jsonl)")


def run_monitor(args) -> int:
    as_json = getattr(args, "as_json", False)
    # --follow polls on a cadence: every ledger read is tail-bounded
    # (the one-shot view reads everything — it runs once)
    tail = MONITOR_TAIL_BYTES if args.follow else None
    if getattr(args, "serve", False):
        while True:
            view = _monitor_serve_once(args.run_dir, tail_bytes=tail)
            if as_json:
                print(json.dumps(view), flush=True)
            else:
                _print_serve_view(view)
            if not args.follow:
                return 0
            time.sleep(max(0.2, args.interval))
    while True:
        view = _monitor_once(args.run_dir, tail_bytes=tail)
        if as_json:
            print(json.dumps(view), flush=True)
        else:
            ss = view.get("step_stats")
            extra = (f"  warm step {ss['mean_s'] * 1e3:.1f} ms"
                     if ss else "")
            if view.get("incidents"):
                extra += f"  [{view['incidents']} incident(s)]"
            print(f"-- {time.strftime('%H:%M:%S')} {args.run_dir}{extra}")
            for rank, info in view["ranks"].items():
                print(f"  rank {rank}: phase={info['phase']} "
                      f"step={info['step']} "
                      f"last span {info['last_span_age_s']}s ago")
            if not view["ranks"]:
                print("  (no span files yet)")
        if not args.follow:
            return 0
        time.sleep(max(0.2, args.interval))
