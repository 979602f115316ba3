"""Event-schema validation for telemetry traces.

Counterpart of ``repro/obs/schema.py``, the same schema and checks. No
schema library: the checks are plain Python over decoded JSONL rows (or
live ``Event`` objects) and return a list of readable error strings; empty
means valid.

    PYTHONPATH=src python -m repro_torch.obs.schema [--selftest] [PATHS...]

Schema (one JSON object per line):

* common required fields: ``kind`` (one of ``EVENT_KINDS``), ``seq`` (int,
  strictly increasing), ``step`` (int >= 0), ``t_sim`` (number,
  non-decreasing), ``t_wall`` (number);
* kind-specific required fields:
  ``upload``: client, tau — ``drop``: client, tau, reason —
  ``flush``: window — ``broadcast``: n_receivers — ``eval``: accuracy —
  ``compile``: entry, retraces;
* tap payloads, when present, are flat ``{name: number}`` dicts keyed by
  the tap layouts (``FLUSH_TAP_NAMES`` on flush events,
  ``COHORT_TAP_NAMES`` on upload events);
* ``eval`` events may carry a ``population`` object: per-state client
  counts keyed by ``POPULATION_STATE_NAMES``, non-negative ints.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, Iterable, List

from repro_torch.obs.events import EVENT_KINDS
from repro_torch.obs.taps import (COHORT_TAP_NAMES, FLUSH_TAP_NAMES,
                            POPULATION_STATE_NAMES)

REQUIRED_COMMON = ("kind", "seq", "step", "t_sim", "t_wall")

REQUIRED_BY_KIND = {
    "upload": ("client", "tau"),
    "drop": ("client", "tau", "reason"),
    "flush": ("window",),
    "broadcast": ("n_receivers",),
    "eval": ("accuracy",),
    "compile": ("entry", "retraces"),
}

_TAP_NAMES_BY_KIND = {
    "flush": FLUSH_TAP_NAMES,
    "upload": COHORT_TAP_NAMES,
}


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_events(rows: Iterable[Dict[str, Any]]) -> List[str]:
    """Validate decoded event dicts; returns a list of error strings
    (empty == schema-valid)."""
    errors: List[str] = []
    last_seq = None
    last_tsim = None
    n = 0
    for i, row in enumerate(rows):
        n += 1
        where = f"event {i}"
        if not isinstance(row, dict):
            errors.append(f"{where}: not an object")
            continue
        missing = [f for f in REQUIRED_COMMON if f not in row]
        if missing:
            errors.append(f"{where}: missing fields {missing}")
            continue
        kind = row["kind"]
        where = f"event {i} ({kind})"
        if kind not in EVENT_KINDS:
            errors.append(f"{where}: unknown kind {kind!r}")
            continue
        if not isinstance(row["seq"], int) or isinstance(row["seq"], bool):
            errors.append(f"{where}: seq is not an int")
        elif last_seq is not None and row["seq"] <= last_seq:
            errors.append(f"{where}: seq {row['seq']} not strictly "
                          f"increasing (previous {last_seq})")
        if isinstance(row["seq"], int):
            last_seq = row["seq"]
        if not isinstance(row["step"], int) or isinstance(row["step"], bool) \
                or row["step"] < 0:
            errors.append(f"{where}: step must be an int >= 0")
        for f in ("t_sim", "t_wall"):
            if not _is_num(row[f]):
                errors.append(f"{where}: {f} is not a number")
        if _is_num(row["t_sim"]):
            if last_tsim is not None and row["t_sim"] < last_tsim:
                errors.append(f"{where}: t_sim {row['t_sim']} decreased "
                              f"(previous {last_tsim})")
            last_tsim = row["t_sim"]
        for f in REQUIRED_BY_KIND[kind]:
            if f not in row:
                errors.append(f"{where}: missing {f!r}")
        pop = row.get("population")
        if pop is not None:
            if kind != "eval":
                errors.append(f"{where}: population not allowed on this kind")
            elif not isinstance(pop, dict):
                errors.append(f"{where}: population is not an object")
            else:
                for k, v in pop.items():
                    if k not in POPULATION_STATE_NAMES:
                        errors.append(f"{where}: unknown population state "
                                      f"{k!r}")
                    elif not isinstance(v, int) or isinstance(v, bool) \
                            or v < 0:
                        errors.append(f"{where}: population count {k!r} must "
                                      f"be an int >= 0")
        taps = row.get("taps")
        if taps is not None:
            names = _TAP_NAMES_BY_KIND.get(kind)
            if names is None:
                errors.append(f"{where}: taps not allowed on this kind")
            elif not isinstance(taps, dict):
                errors.append(f"{where}: taps is not an object")
            else:
                for k, v in taps.items():
                    if k not in names:
                        errors.append(f"{where}: unknown tap {k!r}")
                    elif not _is_num(v):
                        errors.append(f"{where}: tap {k!r} is not a number")
    if n == 0:
        errors.append("trace contains no events")
    return errors


def validate_jsonl(path) -> List[str]:
    """Validate a JSONL trace file; returns error strings (empty == valid)."""
    rows = []
    errors: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: invalid JSON ({e.msg})")
    return errors + validate_events(rows)


def _selftest() -> List[str]:
    """Known-good and known-bad fixtures; returns errors if the validator
    itself misbehaves."""
    good = [
        {"kind": "upload", "seq": 0, "step": 0, "t_sim": 0.5, "t_wall": 1.0,
         "client": 3, "tau": 0,
         "taps": {"delta_norm": 1.5, "upload_qerr_rel": 0.01}},
        {"kind": "flush", "seq": 1, "step": 0, "t_sim": 0.5, "t_wall": 1.1,
         "window": 4, "taps": {"delta_norm": 2.0}},
        {"kind": "broadcast", "seq": 2, "step": 1, "t_sim": 0.5,
         "t_wall": 1.2, "n_receivers": 7},
        {"kind": "drop", "seq": 3, "step": 1, "t_sim": 0.9, "t_wall": 1.3,
         "client": 5, "tau": 12, "reason": "stale"},
        {"kind": "eval", "seq": 4, "step": 1, "t_sim": 1.0, "t_wall": 1.4,
         "accuracy": 0.75,
         "population": {"idle": 120, "working": 8, "offline": 1,
                        "dropped": 0}},
        {"kind": "compile", "seq": 5, "step": 1, "t_sim": 1.0, "t_wall": 1.5,
         "entry": "server_flush", "retraces": 1},
    ]
    bad = [
        {"kind": "nonsense", "seq": 0, "step": 0, "t_sim": 0.0, "t_wall": 0.0},
        {"kind": "upload", "seq": 0, "step": 0, "t_sim": 0.0, "t_wall": 0.0},
        {"kind": "eval", "seq": 0, "step": -1, "t_sim": -1.0, "t_wall": 0.0,
         "accuracy": "high"},
        {"kind": "eval", "seq": 0, "step": 0, "t_sim": 0.0, "t_wall": 0.0,
         "accuracy": 0.5, "population": {"bogus": 1}},
        {"kind": "upload", "seq": 0, "step": 0, "t_sim": 0.0, "t_wall": 0.0,
         "client": 1, "tau": 0, "population": {"idle": 3}},
    ]
    problems = []
    good_errors = validate_events(good)
    if good_errors:
        problems.append(f"valid fixture rejected: {good_errors}")
    if not validate_events(good[:1] + bad):
        problems.append("invalid fixture accepted")
    if not validate_events([]):
        problems.append("empty trace accepted")
    return problems


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="validate telemetry JSONL traces against the event schema")
    ap.add_argument("paths", nargs="*", help="JSONL trace files to validate")
    ap.add_argument("--selftest", action="store_true",
                    help="run validator fixtures before (or without) files")
    args = ap.parse_args(argv)
    rc = 0
    if args.selftest:
        problems = _selftest()
        if problems:
            for p in problems:
                print(f"selftest: {p}", file=sys.stderr)
            rc = 1
        else:
            print("selftest: OK")
    for path in args.paths:
        errors = validate_jsonl(path)
        if errors:
            for e in errors:
                print(f"{path}: {e}", file=sys.stderr)
            rc = 1
        else:
            print(f"{path}: OK")
    if not args.selftest and not args.paths:
        ap.error("nothing to do: pass trace files and/or --selftest")
    return rc


if __name__ == "__main__":
    sys.exit(main())
