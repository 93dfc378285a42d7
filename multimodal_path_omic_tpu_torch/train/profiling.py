"""Device-trace analysis: a ``torch.profiler`` capture as a ranked report
(``multimodal_path_omic_tpu/train/profiling.py``).

``train/logging.py::profile_trace`` (``cli train --profile-dir``) writes a
Chrome trace; :func:`parse_trace` reads it without a viewer: the device
track's operations (kernels, copies, memsets) with their total time, ranked,
in categories for this card (:func:`category`: the port's co-attention,
MIL-pool, flash and gather kernels by their CUDA names, cuBLAS GEMMs,
copies, elementwise kernels, the optimizer), the busy union of the device
track against its traced span and the idle gaps. A trace without a device
track (a CPU run) ranks the host operators by their self time instead.
``cli profile`` trains an untraced warm-up epoch (kernel builds, graph
capture, the cache upload), traces the next epochs and prints the report.

:func:`device_rows`, :func:`split_ms` and :func:`trace_call` read a live
``torch.profiler`` session in the same categories (``chip_smoke.py
--profile`` uses them).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

# CUDA-name fragments -> category, first match wins: the port's kernels
# (csrc/*.cu) by their __global__ names, then the library kernels
CATEGORIES = (
    ("flash_fwd_kernel", "flash forward"), ("flash_bwd", "flash backward"),
    ("milpool", "MIL pool kernel"), ("gather_rows", "row gather kernel"),
    ("fused_k", "coattn kernels"), ("fk_", "coattn kernels"), ("combine_kernel", "coattn kernels"),
    ("bwd_reduce_kernel", "coattn kernels"), ("dwk_kernel", "coattn kernels"),
    ("plain_kernel", "coattn kernels"), ("plain_bwd_kernel", "coattn kernels"),
    ("stats_kernel", "coattn kernels"), ("weights_kernel", "coattn kernels"),
    ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"), ("cublas", "matmul"),
    ("memcpy", "copies"), ("memset", "copies"),
    ("adam", "optimizer"), ("multi_tensor", "optimizer"),
    ("elementwise", "elementwise"), ("reduce_kernel", "elementwise"),
    ("vectorized", "elementwise"), ("softmax", "elementwise"), ("layer_norm", "elementwise"),
    ("index", "elementwise"), ("cat", "elementwise"),
)
# Chrome-trace categories of device-track events (torch.profiler's export)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    low = name.lower()
    return next((part for frag, part in CATEGORIES if frag in low), "other")


def device_rows(prof) -> List[Tuple[str, float, int]]:
    """(name, device ms, count) of the device-side events of a live
    ``torch.profiler`` session, largest first: the host-side aten ops also
    carry their kernels' device time and would count it twice. Raises when
    the profiler recorded no device time."""
    import torch

    rows = []
    for ev in prof.key_averages():
        # user annotations (e.g. "Optimizer.step#Adam.step") span kernels
        # already counted on the device timeline
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    return sorted(rows, key=lambda r: -r[1])


def split_ms(rows: Iterable[Tuple[str, float, int]]) -> Dict[str, float]:
    """Device ms by :func:`category`, largest first."""
    split: Dict[str, float] = defaultdict(float)
    for name, ms, _ in rows:
        split[category(name)] += ms
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def trace_call(call, *args) -> Dict[str, Any]:
    """``call(*args)`` on the card under ``torch.profiler`` (CPU and CUDA
    activities): its synchronized wall ms, the :func:`device_rows`, their
    :func:`split_ms`, the device ms and the busy share (device over wall)."""
    import time

    import torch

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = call(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    return {"out": out, "wall_ms": wall_ms, "rows": rows, "split_ms": split_ms(rows),
            "device_ms": device_ms, "busy_share": device_ms / wall_ms}


def _trace_files(trace_dir: str) -> List[str]:
    """The newest Chrome trace under ``trace_dir`` (``profile_trace`` writes
    one file a capture)."""
    if os.path.isfile(trace_dir):
        return [trace_dir]
    paths = [p for pat in ("*.json", "*.json.gz", "*.pt.trace.json")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.json trace under {trace_dir}: was it captured with "
                                "torch.profiler (profile_trace / --profile-dir)?")
    return [max(set(paths), key=os.path.getmtime)]


def _load_events(trace_dir: str) -> List[dict]:
    """The complete ('X') events of the newest trace under ``trace_dir``."""
    events: List[dict] = []
    for p in _trace_files(trace_dir):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            data = json.load(f)
        events.extend(e for e in data.get("traceEvents", [])
                      if e.get("ph") == "X" and "ts" in e)
    return events


def _busy_union_us(evs: List[dict]) -> float:
    """Total time covered by at least one event (merged intervals), in us."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in evs if e.get("dur"))
    busy = 0.0
    cur_s = cur_e = None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _self_times(evs: List[dict]) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Self time (duration less its nested children's) and count per name,
    each (pid, tid) track a stack of enclosing spans."""
    tot: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    by_tid: Dict[Any, List[dict]] = defaultdict(list)
    for e in evs:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)

    def close(done):
        tot[done["name"]] += max(done["dur"] - done["child"], 0.0)
        cnt[done["name"]] += 1

    for track in by_tid.values():
        track.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack: List[dict] = []
        for e in track:
            dur = float(e.get("dur", 0))
            ts = float(e["ts"])
            while stack and ts >= stack[-1]["end"] - 1e-9:
                close(stack.pop())
            if stack:
                stack[-1]["child"] += dur
            stack.append({"name": e["name"], "end": ts + dur, "dur": dur, "child": 0.0})
        while stack:
            close(stack.pop())
    return tot, cnt


def parse_trace(trace_dir: str, steps: Optional[int] = None) -> Dict[str, Any]:
    """Aggregate the device track of a ``torch.profiler`` Chrome trace (a
    file, or the newest under a directory): per-operation totals ranked by
    device time, the :func:`category` breakdown, the busy union over the
    traced span, the idle gaps between device operations and, with
    ``steps``, a per-step normalization. Without a device track (a CPU run)
    the host operators are ranked by self time (``fallback_track``)."""
    events = _load_events(trace_dir)
    evs = [e for e in events if e.get("cat") in DEVICE_CATS]
    fallback = not evs
    if fallback:
        evs = [e for e in events if e.get("cat") == "cpu_op"]
    if fallback:  # host operators nest: rank by self time
        tot, cnt = _self_times(evs)
    else:  # device operations do not nest (concurrent streams are their own tracks)
        tot, cnt = defaultdict(float), defaultdict(int)
        for e in evs:
            tot[e["name"]] += float(e.get("dur", 0))
            cnt[e["name"]] += 1
    ops = sorted(({"name": k, "total_us": v, "count": cnt[k], "category": category(k)}
                  for k, v in tot.items()), key=lambda r: -r["total_us"])
    cats: Dict[str, float] = defaultdict(float)
    for r in ops:
        cats[r["category"]] += r["total_us"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in evs if e.get("dur"))
    wall_us = max(t for _, t in spans) - spans[0][0] if spans else 0.0
    busy = _busy_union_us(evs)
    gaps, end = [], None
    for s, t in spans:
        if end is not None and s > end:
            gaps.append(s - end)
        end = t if end is None else max(end, t)
    tail = [r for r in ops if steps and r["total_us"] / steps < 3.0]
    return {
        "tracks": sorted({f"{e.get('pid')}:{e.get('tid')}" for e in evs}),
        "fallback_track": fallback,
        "ops": ops,
        "categories": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "total_op_us": sum(r["total_us"] for r in ops),
        "busy_union_us": busy,
        "wall_us": wall_us,
        "idle_us": max(wall_us - busy, 0.0),
        "idle_gaps": len(gaps),
        "largest_gap_us": max(gaps, default=0.0),
        "steps": steps,
        "tail_op_count": len(tail),
        "tail_us": sum(r["total_us"] for r in tail),
    }


def format_report(summary: Dict[str, Any], top: int = 25) -> str:
    """The ranked report of a :func:`parse_trace` summary."""
    steps = summary.get("steps")
    div = steps or 1
    unit = "us/step" if steps else "us total"
    lines = [f"trace tracks: {len(summary['tracks'])} (pid:tid)"
             + ("  [no device track: host operators by self time]"
                if summary["fallback_track"] else "  [device]")]
    lines.append(f"device op-time {summary['total_op_us'] / 1e3:.2f} ms"
                 + (f"  ({summary['total_op_us'] / div:.1f} us/step over {steps} steps)"
                    if steps else ""))
    if summary["wall_us"]:
        occ = 100.0 * summary["busy_union_us"] / summary["wall_us"]
        lines.append(f"occupancy {occ:.1f}% (busy-union {summary['busy_union_us'] / 1e3:.2f} ms"
                     f" / traced span {summary['wall_us'] / 1e3:.2f} ms); idle "
                     f"{summary['idle_us'] / 1e3:.2f} ms in {summary['idle_gaps']} gaps, the "
                     f"largest {summary['largest_gap_us'] / 1e3:.3f} ms")
    lines.append("categories: " + "  ".join(
        f"{k} {v / div:.1f}" for k, v in summary["categories"].items()) + f"  [{unit}]")
    if steps:
        lines.append(f"sub-3us/step tail: {summary['tail_op_count']} distinct ops,"
                     f" {summary['tail_us'] / div:.1f} us/step")
    lines.append("")
    lines.append(f"{'rank':>4}  {unit:>12}  {'count':>7}  {'category':<18} op")
    for i, r in enumerate(summary["ops"][:top], 1):
        lines.append(f"{i:>4}  {r['total_us'] / div:>12.2f}  {r['count']:>7}  "
                     f"{r['category']:<18} {r['name'][:100]}")
    return "\n".join(lines)


def profile_training(trainer, trace_dir: str, epochs: int = 1, top: int = 25,
                     verbose: bool = True) -> Dict[str, Any]:
    """One untraced warm-up epoch (kernel builds, graph capture, the cache
    upload), then ``epochs`` training epochs traced into ``trace_dir`` and
    parsed. Returns the :func:`parse_trace` summary (printed with
    ``verbose``)."""
    from multimodal_path_omic_tpu_torch.train.logging import profile_trace

    trainer.train_epoch(0)
    n_steps = 0
    with profile_trace(trace_dir):
        for e in range(1, 1 + epochs):
            trainer.train_epoch(e)
            n_steps += getattr(trainer, "last_epoch_steps", 0)
    summary = parse_trace(trace_dir, steps=n_steps or None)
    if verbose:
        print(format_report(summary, top=top))
    return summary
