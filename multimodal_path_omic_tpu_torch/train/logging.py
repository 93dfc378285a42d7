"""Observability: stdout metrics, optional wandb, a JSONL run log and step
timing (``multimodal_path_omic_tpu/train/logging.py``).

The reference logs per-epoch train/val loss + c-index to stdout and wandb
(reference: mcat/main.py:85-87, 101-103, 153-155, 186-215) and prints a
per-50-batch speed figure with a /32-vs-50 divisor bug (mcat/main.py:63-68;
fixed here: the timer divides by the window's own length). A JSONL sink
records the run. With ``wandb_enabled`` the metrics also go to a wandb run:
``wandb`` is imported only then, and its absence raises ``ImportError``
(no run is silently dropped).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, *, wandb_enabled: bool = False, wandb_project: str = "",
                 wandb_config: Optional[Dict[str, Any]] = None,
                 jsonl_path: Optional[str] = None):
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._wandb = None
        if wandb_enabled:
            try:
                import wandb
            except ImportError as exc:
                raise ImportError("wandb.enabled is set but the wandb package is not "
                                  "installed: install it or set wandb.enabled: false") from exc
            os.environ.setdefault("WANDB__SERVICE_WAIT", "300")
            wandb.init(project=wandb_project, settings=wandb.Settings(init_timeout=300),
                       config=wandb_config or {})
            self._wandb = wandb

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        # epochs run after finish() must not crash on a finished run or a
        # closed sink
        if self._wandb is not None and getattr(self._wandb, "run", None) is not None:
            self._wandb.log(metrics, step=step)
        if self._jsonl is not None and not self._jsonl.closed:
            rec = dict(metrics)
            if step is not None:
                rec["step"] = step
            rec["time"] = time.time()
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()


class StepTimer:
    """Windowed steps/sec + bags/sec tracker (fixes mcat/main.py:67's divisor)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._bags = 0

    def tick(self, bags: int = 1):
        self._steps += 1
        self._bags += bags

    def rates(self):
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._steps / dt, self._bags / dt


def profile_trace(log_dir: str):
    """Context manager capturing a ``torch.profiler`` trace (CPU activity,
    and CUDA where a GPU is present) of its body, written on exit to
    ``<log_dir>/trace_<time>.json`` (Chrome trace format, the file
    ``train/profiling.py::parse_trace`` reads; JAX ``logging.py:92``)."""
    import contextlib
    import datetime

    import torch

    @contextlib.contextmanager
    def _ctx():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S_%f")
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))

    return _ctx()
