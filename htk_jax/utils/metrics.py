"""Structured metrics + profiler hooks (SURVEY.md §5.1/§5.5 rebuild).

The reference's observability is stdout prints under trace flags plus
HResults' report — kept verbatim for recipe compatibility. This module
adds the machine-readable side-channel the survey called for:

  HTKTPU: METRICS = file   append one JSON line per tool milestone
                           (tool, wall time, the tool's key numbers)
  HTKTPU: PROFILE = dir    wrap the tool's device hot loop in a
                           jax.profiler trace written under dir/<tool>
                           (view with TensorBoard / xprof)

Both are config-driven no-ops by default, so nothing changes for stock
recipes.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


def emit_metric(cfg, tool: str, **record) -> None:
    """Append one JSONL metrics record if HTKTPU:METRICS is configured."""
    path = cfg.str_("METRICS", None, module="HTKTPU") if cfg else None
    if not path:
        return
    rec = {"tool": tool, "ts": round(time.time(), 3)}
    rec.update(record)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def maybe_profile(cfg, tool: str):
    """jax.profiler trace around a tool's hot loop when configured."""
    d = cfg.str_("PROFILE", None, module="HTKTPU") if cfg else None
    if not d:
        yield
        return
    import jax

    out = os.path.join(d, tool)
    os.makedirs(out, exist_ok=True)
    jax.profiler.start_trace(out)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
