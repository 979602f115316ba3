"""Telemetry: metric taps and structured run tracing.

Counterpart of ``repro/obs``. Two halves:

* **Taps** (``obs.taps``, math in ``kernels.taps``): device-computed
  scalars of every flush (norms of the delta, the update, the broadcast
  diff and its decode, the broadcast's relative quantization error, the
  staleness weights' sum and minimum) and of every upload (delta norm,
  relative quantization error), taken with ``taps=True`` on
  ``kernels.ops.server_flush_step`` / ``cohort_train_encode_step``: one
  more launch each, in a fixed reduction order, so tap values are the same
  in both engines and on both devices.
* **Run tracing** (``obs.events``): a ``RunTracer`` recording typed events
  (upload, drop, flush, broadcast, eval, compile) with simulated and wall
  clock into a bounded ring, exported as JSONL (``obs.schema`` validates
  it), summarized by ``obs.report``.

``obs.metrics.collect`` is the one metrics surface: the traffic and
staleness keys as before, plus the tracer's tap series when a tracer is
attached.
"""
from repro_torch.obs.events import EVENT_KINDS, CompileWatch, Event, RunTracer
from repro_torch.obs.metrics import collect
from repro_torch.obs.records import AccuracyPoint
from repro_torch.obs.report import report_rows, summary_table, write_jsonl
from repro_torch.obs.schema import validate_events, validate_jsonl
from repro_torch.obs.taps import (COHORT_TAP_NAMES, FLUSH_TAP_NAMES,
                                  cohort_tap_rows, flush_tap_vector,
                                  named_cohort_taps, named_flush_taps)

__all__ = [
    "AccuracyPoint",
    "COHORT_TAP_NAMES",
    "CompileWatch",
    "EVENT_KINDS",
    "Event",
    "FLUSH_TAP_NAMES",
    "RunTracer",
    "cohort_tap_rows",
    "collect",
    "flush_tap_vector",
    "named_cohort_taps",
    "named_flush_taps",
    "report_rows",
    "summary_table",
    "validate_events",
    "validate_jsonl",
    "write_jsonl",
]
