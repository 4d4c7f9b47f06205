"""Chrome/Perfetto ``trace_event`` export for recorded engine traces (port
of ``repro/core/transport/trace_export.py``; host code, numpy and the
standard library).

Turns a :class:`~repro_torch.core.transport.telemetry.TraceRecorder` into the
JSON Trace Event Format that https://ui.perfetto.dev (and Chrome's
``about:tracing``) render natively:

- one **process** per NIC design (``pid`` = design index, named via
  ``M``/``process_name`` metadata),
- one **thread** per schedule phase (``tid`` = phase index + 1), whose
  ``X`` complete-events are the per-step critical-path slices — ``ts``
  is the cumulative natural time, ``dur`` the step's natural duration,
  and ``args`` the critical flow's component decomposition (telemetry
  .COMPONENTS), its sender node and tier — so a p99 round's timeline
  shows *where* the microseconds went,
- a **round marker thread** (``tid`` 0) with one slice per round
  carrying the per-cause loss attribution and, for Celeris, the window
  cut,
- **counter tracks** (``C``) per design for the delivered fraction.

The export is **streamed**: :func:`iter_trace_events` is a generator
over round-chunks (``chunk_rounds`` rounds per design at a time), so a
multi-thousand-round recording never holds its full event list — let
alone the serialized JSON — in memory.  :func:`write_trace` consumes
it chunk-by-chunk, runs the schema gate (:func:`validate_events`) on
every chunk *before* that chunk hits the file, and deletes the partial
file if any chunk fails.  :func:`to_trace_events` still materializes
the whole object for small recordings and tests; :func:`validate_trace`
is the whole-file round-trip gate.  The exporter only reads the
recorder.  The event schema is ``docs/OBSERVABILITY.md``'s.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np

from repro_torch.core.transport import telemetry, topology

_EVENT_TYPES = ("X", "C", "M", "i")
_ROUND_TID = 0
_CHUNK_ROUNDS = 64


def _meta_events(recorder: telemetry.TraceRecorder,
                 designs: List[str]) -> List[dict]:
    events: List[dict] = []
    for pid, d in enumerate(designs):
        rec = recorder.records[d]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"design:{d}"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": _ROUND_TID, "args": {"name": "rounds"}})
        for k, pn in enumerate(rec.phase_names):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": k + 1, "args": {"name": f"phase:{pn}"}})
    return events


def _round_events(rec, pid: int, r: int, ts: float, step_dur, nat,
                  lost, offered) -> tuple[List[dict], float]:
    """Events for one round starting at cumulative time ``ts``; returns
    (events, ts after the round)."""
    cc = rec.comp_crit
    steps = rec.steps
    t0 = ts
    events: List[dict] = [{
        "name": f"round {r}", "ph": "X", "pid": pid, "tid": _ROUND_TID,
        "ts": round(t0, 3), "dur": round(float(nat[r]), 3),
        "cat": "round", "args": _round_args(rec, r, lost, offered)}]
    for s in range(steps):
        i = r * steps + s
        k = int(rec.phase_of_step[s])
        comp = {name: round(float(cc[i, ci]), 3)
                for ci, name in enumerate(telemetry.COMPONENTS)
                if cc[i, ci] > 0}
        tier = int(rec.crit_tier[i])
        events.append({
            "name": rec.phase_names[k], "ph": "X", "pid": pid,
            "tid": k + 1, "ts": round(ts, 3),
            "dur": round(float(step_dur[r, s]), 3), "cat": "step",
            "args": {"components_us": comp,
                     "critical_src": int(rec.crit_src[i]),
                     "critical_tier": (topology.TIERS[tier]
                                       if tier >= 0 else "?")}})
        ts += float(step_dur[r, s])
    ts = t0 + float(nat[r])
    if rec.stats is not None:
        events.append({
            "name": "delivered_frac", "ph": "C", "pid": pid,
            "tid": _ROUND_TID, "ts": round(t0, 3),
            "args": {"frac": round(
                float(np.asarray(rec.stats.recv_frac)[r]), 6)}})
    return events, ts


def _round_args(rec, r: int, lost, offered) -> dict:
    args: dict = {}
    lost_r = lost[r].sum(axis=0)
    off = max(float(offered[r].sum()), 1.0)
    args["loss_by_cause"] = {
        c: round(float(lost_r[i]) / off, 6)
        for i, c in enumerate(telemetry.CAUSES) if lost_r[i] > 0}
    if rec.elapsed_us is not None:
        args["elapsed_us"] = round(float(rec.elapsed_us[r]), 3)
    if rec.window_cut_pkts is not None:
        cut = float(rec.window_cut_pkts[r].sum())
        if cut > 0:
            args["window_cut_pkts"] = round(cut, 3)
    return args


def iter_trace_events(recorder: telemetry.TraceRecorder, *,
                      max_rounds: int | None = None,
                      chunk_rounds: int = _CHUNK_ROUNDS
                      ) -> Iterator[List[dict]]:
    """Generator over the export: first a metadata chunk (process/thread
    names for every design), then one chunk per ``chunk_rounds`` rounds
    per design.  Peak memory is one chunk's events, independent of the
    recording length; ``max_rounds`` caps the exported rounds per design
    (None = all)."""
    if not recorder.records:
        raise ValueError("recorder holds no records: run "
                         "BatchedEngine(params, recorder=rec).traces(...) "
                         "first")
    if chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    designs = sorted(recorder.records)
    yield _meta_events(recorder, designs)
    for pid, d in enumerate(designs):
        rec = recorder.records[d]
        R = rec.n_rounds if max_rounds is None else min(rec.n_rounds,
                                                        max_rounds)
        steps = rec.steps
        step_dur = rec.comp_crit.reshape(rec.n_rounds, steps, -1).sum(axis=2)
        nat = (rec.natural_us if rec.natural_us is not None
               else step_dur.sum(axis=1))
        lost = rec.loss_by_cause()
        offered = rec.offered_round()
        ts = 0.0
        for r0 in range(0, R, chunk_rounds):
            chunk: List[dict] = []
            for r in range(r0, min(r0 + chunk_rounds, R)):
                events, ts = _round_events(rec, pid, r, ts, step_dur, nat,
                                           lost, offered)
                chunk.extend(events)
            yield chunk


def _other_data(recorder: telemetry.TraceRecorder,
                max_rounds: int | None, meta: dict | None) -> dict:
    other = {"generator": "repro_torch.core.transport.trace_export",
             "components": list(telemetry.COMPONENTS),
             "causes": list(telemetry.CAUSES),
             "designs": sorted(recorder.records),
             "max_rounds": max_rounds}
    if meta:
        other.update(meta)
    return other


def to_trace_events(recorder: telemetry.TraceRecorder, *,
                    max_rounds: int | None = None,
                    meta: dict | None = None) -> dict:
    """Build the full trace_event JSON object for every recorded design.

    Materializes every chunk of :func:`iter_trace_events` — fine for
    short recordings and tests; long recordings should stream through
    :func:`write_trace` instead.  ``max_rounds`` caps the exported
    rounds per design (None = all); the cap is recorded in
    ``otherData`` so a truncated export never masquerades as full
    coverage.
    """
    events = [ev
              for chunk in iter_trace_events(recorder, max_rounds=max_rounds)
              for ev in chunk]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": _other_data(recorder, max_rounds, meta)}


def write_trace(recorder: telemetry.TraceRecorder, path: str, *,
                max_rounds: int | None = None,
                meta: dict | None = None,
                chunk_rounds: int = _CHUNK_ROUNDS) -> Dict[str, int]:
    """Stream the export to ``path`` chunk-by-chunk.

    Each chunk of :func:`iter_trace_events` passes the per-event schema
    gate (:func:`validate_events`) before it is serialized, so peak
    memory is one chunk regardless of the recording length and nothing
    schema-invalid ever reaches the file; a failed chunk (or failed
    aggregate check) deletes the partial file and re-raises.  Returns
    the per-event-type counts — the same shape :func:`validate_trace`
    returns for the whole file.
    """
    other = _other_data(recorder, max_rounds, meta)
    counts: Dict[str, int] = {}
    try:
        with open(path, "w") as f:
            f.write('{"traceEvents": [')
            sep = ""
            for chunk in iter_trace_events(recorder, max_rounds=max_rounds,
                                           chunk_rounds=chunk_rounds):
                validate_events(chunk, counts=counts)
                for ev in chunk:
                    f.write(sep)
                    json.dump(ev, f)
                    sep = ", "
            if counts.get("M", 0) == 0:
                raise ValueError("no metadata (M) events: process/thread "
                                 "names are required for a readable "
                                 "Perfetto view")
            if counts.get("X", 0) == 0:
                raise ValueError("no slice (X) events")
            f.write('], "displayTimeUnit": "ms", "otherData": ')
            json.dump(other, f)
            f.write("}")
    except BaseException:
        try:
            os.remove(path)
        except OSError:
            pass
        raise
    return counts


def _validate_event(i: int, ev, comps: set,
                    counts: Dict[str, int]) -> None:
    if not isinstance(ev, dict):
        raise ValueError(f"event {i}: not an object")
    ph = ev.get("ph")
    if ph not in _EVENT_TYPES:
        raise ValueError(f"event {i}: unknown ph {ph!r}")
    counts[ph] = counts.get(ph, 0) + 1
    for field in ("name", "pid", "tid"):
        if field not in ev:
            raise ValueError(f"event {i} ({ph}): missing {field!r}")
    if ph in ("X", "C", "i"):
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} ({ph}): bad ts {ts!r}")
    if ph == "X":
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or dur < 0:
            raise ValueError(f"event {i} (X): bad dur {dur!r}")
        args = ev.get("args", {})
        bad = set(args.get("components_us", {})) - comps
        if bad:
            raise ValueError(
                f"event {i} (X): unknown components {sorted(bad)}")
    if ph == "C" and not isinstance(ev.get("args"), dict):
        raise ValueError(f"event {i} (C): counter needs args object")


def validate_events(events, *, components=None,
                    counts: Dict[str, int] | None = None) -> Dict[str, int]:
    """Per-chunk schema gate: validate a list of events (required fields
    by phase type, numeric non-negative ``ts``/``dur``, component args
    limited to the published schema).  Raises ``ValueError`` with the
    first violation; accumulates into and returns ``counts`` so a
    streaming writer can fold per-chunk results into whole-file totals.
    Aggregate checks (at least one M and one X event) are the caller's
    job — a single chunk legitimately carries only one event type."""
    comps = set(telemetry.COMPONENTS if components is None else components)
    if counts is None:
        counts = {}
    if not isinstance(events, list):
        raise ValueError("event chunk must be a list")
    for i, ev in enumerate(events):
        _validate_event(i, ev, comps, counts)
    return counts


def validate_trace(obj) -> Dict[str, int]:
    """Schema validator for a complete export (and anything claiming to
    be a trace_event JSON we produced).  Raises ``ValueError`` with the
    first violation; returns per-event-type counts on success.  Checks:
    top-level shape, the per-event gate of :func:`validate_events`, and
    the aggregate requirements (metadata and slice events present)."""
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object")
    for key in ("traceEvents", "otherData"):
        if key not in obj:
            raise ValueError(f"trace missing top-level {key!r}")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    comps = obj["otherData"].get("components", telemetry.COMPONENTS)
    counts = validate_events(events, components=comps)
    if counts.get("M", 0) == 0:
        raise ValueError("no metadata (M) events: process/thread names "
                         "are required for a readable Perfetto view")
    if counts.get("X", 0) == 0:
        raise ValueError("no slice (X) events")
    return counts
