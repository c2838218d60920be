"""The reading of a device trace: busy time as the union of the device's
intervals, per-kernel sums, and idle time by the harness span open."""

import pytest

from harness.record import Span
from harness.trace import MARKER, merge, summarize


def test_merge_takes_the_union():
    assert merge([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]


def test_summary_puts_device_time_on_the_host_clock():
    # Device clock = host clock + 100 s; the marker starts at host 10.0.
    ev = [(MARKER, 110.0, 110.001),
          ("beam_scan_kernel<2>", 111.0, 111.5),
          ("beam_scan_kernel<2>", 111.25, 111.75),   # overlaps the first
          ("Memcpy HtoD", 112.0, 112.25),
          ("late_kernel", 114.5, 116.0)]             # clipped at 15.0
    spans = [Span("api.call", 10.5, 14.0, None, 0),
             Span("api.phase", 10.5, 11.9, 0, 0),
             Span("api.refine", 11.9, 14.0, 0, 0),
             Span("api.call", 14.0, 15.0, None, 1)]
    s = summarize(ev, 10.0, (10.5, 15.0), spans)
    assert s.window_s == pytest.approx(4.5)
    assert s.busy_s == pytest.approx(0.75 + 0.25 + 0.5)
    assert s.kernel_s["beam_scan_kernel<2>"] == pytest.approx(1.0)
    assert s.kernel_s["late_kernel"] == pytest.approx(0.5)
    assert s.transfer_s == pytest.approx(0.25)
    idle = dict(s.idle_gaps)
    assert idle["api.phase"] == pytest.approx(0.5 + 0.15)
    assert idle["api.refine"] == pytest.approx(0.1 + 1.75)
    assert idle["api.call"] == pytest.approx(0.5)
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)


def test_a_trace_without_the_marker_is_refused():
    with pytest.raises(RuntimeError):
        summarize([("k", 1.0, 2.0)], 0.0, (0.0, 3.0), [])
