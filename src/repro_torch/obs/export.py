"""Trace/metric exporters (the port's copy of ``repro.obs.export``; the
same events and snapshot give byte-equal files).

Three formats, all plain text so post-mortems need no tooling:

- **JSONL span stream** — one Chrome ``trace_event`` object per line.
  Line-oriented so a crash mid-write loses one event, not the file.
- **Chrome trace document** — the same events wrapped as
  ``{"traceEvents": [...]}``; chrome://tracing and Perfetto open it
  directly (they do not read bare JSONL).
- **Prometheus text format** — ``# HELP`` + ``# TYPE`` + sample line per
  numeric telemetry-snapshot key, for scrape-style collection (file via
  :func:`write_prometheus`, string via :func:`prometheus_text` — the
  ``/metrics`` ops endpoint serves the latter).

``validate_events``/``validate_jsonl`` check the span schema the tracer
promises: required fields present,
phase is a known ``trace_event`` type, complete spans carry a
non-negative microsecond duration, args is an object.
:func:`validate_exposition` does the same for the Prometheus text:
well-formed metric names, HELP/TYPE preceding each sample, parseable
finite values.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, Iterable, List

# fields every exported event must carry (Chrome trace_event format)
REQUIRED_FIELDS = ("name", "ph", "ts", "pid", "tid")
# phases the tracer emits: X = complete span, i = instant, M = metadata
KNOWN_PHASES = ("X", "i", "M")

# characters folded to "_" when deriving a metric name from a snapshot key
_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# a well-formed exposition metric name (no leading digit)
VALID_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


def write_jsonl(events: Iterable[Dict[str, Any]], path: str) -> str:
    """Write events as one-JSON-object-per-line; returns the path."""
    _ensure_dir(path)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True))
            f.write("\n")
    return path


def write_chrome(events: Iterable[Dict[str, Any]], path: str) -> str:
    """Write the Perfetto/chrome://tracing-loadable twin document."""
    _ensure_dir(path)
    doc = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.write("\n")
    return path


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def validate_events(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Schema-check a span stream; returns a list of violations
    (empty = valid). Checked per event: required trace_event fields, a
    known phase, numeric non-negative ``ts`` (and ``dur`` for complete
    spans), and dict-typed ``args``."""
    errors: List[str] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in REQUIRED_FIELDS if k not in ev]
        if missing:
            errors.append(f"event {i}: missing fields {missing}")
            continue
        if ev["ph"] not in KNOWN_PHASES:
            errors.append(f"event {i}: unknown phase {ev['ph']!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            errors.append(f"event {i}: bad name {ev.get('name')!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            errors.append(f"event {i}: bad ts {ev.get('ts')!r}")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: complete span with bad dur "
                              f"{dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"event {i}: args is not an object")
    return errors


def validate_jsonl(path: str) -> List[str]:
    """Validate a JSONL trace file; returns violations (empty = valid)."""
    try:
        events = read_jsonl(path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable: {e}"]
    if not events:
        return ["no events"]
    return validate_events(events)


def metric_name(key: str, prefix: str = "repro") -> str:
    """Derive a well-formed exposition metric name from a snapshot key:
    fold characters outside ``[a-zA-Z0-9_:]`` to ``_`` and guard the
    no-leading-digit rule. Raises if the result is still invalid
    (empty key / empty prefix edge cases) — a malformed name must fail
    at render time, not at the scraper."""
    name = _METRIC_NAME_RE.sub("_", f"{prefix}_{key}" if prefix else key)
    if name and name[0].isdigit():
        name = "_" + name
    if not VALID_METRIC_NAME_RE.match(name):
        raise ValueError(f"cannot derive a valid metric name from "
                         f"key={key!r} prefix={prefix!r}")
    return name


def prometheus_text(snapshot: Dict[str, Any], prefix: str = "repro") -> str:
    """Render a telemetry snapshot as Prometheus text exposition format
    (all gauges, with ``# HELP`` / ``# TYPE`` per metric).

    Non-numeric and non-finite values are skipped. Keys folding to the
    same metric name keep the first (sorted) key — names are never
    emitted twice, which the exposition format forbids.
    """
    lines = []
    seen = set()
    for key in sorted(snapshot):
        val = snapshot[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        if isinstance(val, float) and not math.isfinite(val):
            continue
        name = metric_name(key, prefix)
        if name in seen:
            continue
        seen.add(name)
        lines.append(f"# HELP {name} telemetry snapshot key {key!r}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(val):.9g}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(snapshot: Dict[str, Any], path: str,
                     prefix: str = "repro") -> str:
    """Write :func:`prometheus_text` to a file; returns the path."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(prometheus_text(snapshot, prefix=prefix))
    return path


def validate_exposition(text: str) -> List[str]:
    """Schema-check Prometheus text exposition; returns violations
    (empty = valid). Checked: metric-name well-formedness on every
    sample and comment line, each sample preceded by its own HELP and
    TYPE, values parse to finite floats, no duplicate sample names."""
    errors: List[str] = []
    helped, typed, sampled = set(), set(), set()
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                errors.append(f"line {i}: truncated comment {line!r}")
                continue
            name = parts[2]
            if not VALID_METRIC_NAME_RE.match(name):
                errors.append(f"line {i}: bad metric name {name!r}")
            (helped if parts[1] == "HELP" else typed).add(name)
            continue
        if line.startswith("#"):
            continue   # free-form comment: legal, uncheckable
        parts = line.split()
        if len(parts) < 2:
            errors.append(f"line {i}: malformed sample {line!r}")
            continue
        name = parts[0].split("{", 1)[0]
        if not VALID_METRIC_NAME_RE.match(name):
            errors.append(f"line {i}: bad metric name {name!r}")
            continue
        if name in sampled:
            errors.append(f"line {i}: duplicate metric {name!r}")
        sampled.add(name)
        if name not in helped:
            errors.append(f"line {i}: {name!r} sample without # HELP")
        if name not in typed:
            errors.append(f"line {i}: {name!r} sample without # TYPE")
        try:
            val = float(parts[-1])
        except ValueError:
            errors.append(f"line {i}: unparseable value {parts[-1]!r}")
            continue
        if not math.isfinite(val):
            errors.append(f"line {i}: non-finite value {parts[-1]!r}")
    if not sampled:
        errors.append("no samples")
    return errors
