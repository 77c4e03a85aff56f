"""The arithmetic of every metric, over one window (`run.Window`).

Each metric's own file under `tilebench/metrics/` names one of these;
the harness finds that file by the metric's name.  A reader that finds
nothing to read returns None and the metric is left out of the line; a
roofline or idle share is never made 0 for want of a reading.
"""

from __future__ import annotations

from typing import Optional

from tilebench import trace

# A load generator's record: [sequence index, key index, sent, done
# (monotonic s), HTTP status (0: no answer), body bytes, body digest].
DONE, STATUS = 3, 4


def tiles_per_s(w) -> Optional[float]:
    """Answers with status 200 that completed inside the window, over
    the window's whole length."""
    t1 = w.t0 + w.seconds
    return sum(1 for r in w.records if r[STATUS] == 200 and w.t0 <= r[DONE] < t1) / w.seconds


def setup_s(w) -> Optional[float]:
    return w.setup_s


def batch_tiles_mean(w) -> Optional[float]:
    return sum(w.batches) / len(w.batches) if w.batches else None


def _span_ms_per_tile(w, span: str) -> Optional[float]:
    if not w.tiles_done or span not in w.spans:
        return None
    return 1e3 * w.spans[span] / w.tiles_done


def entities_ms_per_tile(w) -> Optional[float]:
    return _span_ms_per_tile(w, "Get tile entities (batch share)")


def prepare_ms_per_tile(w) -> Optional[float]:
    return _span_ms_per_tile(w, "Prepare device batch (batch share)")


def encode_ms_per_tile(w) -> Optional[float]:
    return _span_ms_per_tile(w, "Compose and encode")


def _roofline(w, needle: str, bound_key: str) -> Optional[float]:
    if w.trace is None:
        return None
    spent = trace.kernel_s(w.trace["by_name"], needle)
    if spent <= 0:
        return None
    return 100.0 * w.trace[bound_key] / spent


def render_roofline(w) -> Optional[float]:
    return _roofline(w, "render_kernel", "render_bound_s")


def wire_roofline(w) -> Optional[float]:
    return _roofline(w, "wire_kernel", "wire_bound_s")


def device_idle_share(w) -> Optional[float]:
    if w.trace is None or w.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
