"""The span readers (``port_bench/spans.py``) and the eight metrics built on
them, on a ``trace.Trace`` made from synthetic profiler events: a range and
its same-named projection onto the device merge, idle time under a union
of ranges, occurrences as connected components, and None wherever there is
no trace or the program recorded no ``atsm.`` range."""

import pytest

from port_bench import harness, spans
from port_bench import trace as tracing

METRICS = ["pcm_idle_ms.serve", "pcm_assemble_ms.serve",
           "window_captures.serve", "block_ms.stream", "stream_idle_ms.stream",
           "text_tower_ms.stream", "batch_idle_ms.train", "step_idle_ms.train"]


class _Ev:
    """What ``trace.Trace`` reads of a Kineto event."""

    def __init__(self, name, a, b, cuda=False, annotation=False):
        self._n, self._a, self._b = name, a, b
        self._cuda, self._ann = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann


def _kernel(a, b):
    return _Ev("void some_kernel<float>()", a, b, cuda=True)


def _span(name, a, b):
    """A host range and its projection onto the device, which starts at
    its first kernel and may end after the host range does."""
    return [_Ev(name, a, b), _Ev(name, a + 5, b + 60, cuda=True,
                                 annotation=True)]


def _run(events, records=None):
    trace = tracing.Trace([_Ev(tracing.WINDOW_SPAN, 0, 1000)] + events)
    return harness.Run(None, None, records or [{"start": 0, "end": 1}],
                       0.0, {}, trace)


def test_a_range_and_its_projection_merge():
    run = _run([_kernel(0, 50)] + _span("atsm.a", 100, 200))
    assert spans.union(run, ["atsm.a"]) == [(100, 260)]
    assert spans.occurrences(run, "atsm.a") == 1
    assert spans.span_ms(run, ["atsm.a"], 1) == pytest.approx(160e-6)
    # the projection is no device work
    assert run.trace.busy_s == pytest.approx(50e-9)


def test_idle_under_a_union_of_ranges():
    # device busy 0-50, 120-130, 300-400; gaps 50-120, 130-300, 400-1000
    events = [_kernel(0, 50), _kernel(120, 130), _kernel(300, 400),
              _Ev("atsm.b", 100, 200), _Ev("atsm.c", 180, 320),
              _Ev("atsm.d", 900, 2000)]
    run = _run(events)
    # b and c merge to 100-320: (100, 120) + (130, 300) idle
    assert spans.idle_under_ms(run, ["atsm.b", "atsm.c"], 1) == \
        pytest.approx(190e-6)
    # d is clipped to the window's end
    assert spans.idle_under_ms(run, ["atsm.d"], 2) == pytest.approx(50e-6)
    assert spans.idle_under_ms(run, ["atsm.e"], 1) == 0.0


def test_occurrences_are_connected_components():
    run = _run([_Ev("atsm.c", 10, 20), _Ev("atsm.c", 20, 30),
                _Ev("atsm.c", 25, 28), _Ev("atsm.c", 40, 50),
                _Ev("atsm.x", 60, 70)])
    assert spans.occurrences(run, "atsm.c") == 2
    assert spans.occurrences(run, "atsm.none") == 0


def test_nothing_is_read_without_the_programs_ranges():
    run = _run([_kernel(0, 50), _Ev("bench.separate_all_pcm", 0, 900),
                _Ev("aten::copy_", 60, 70)])
    assert spans.occurrences(run, "atsm.program.capture") is None
    assert spans.span_ms(run, ["atsm.pcm.assemble"], 3) is None
    assert spans.idle_under_ms(run, ["atsm.separate_all_pcm"], 3) is None


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_is_none_without_a_trace(name):
    run = harness.Run(None, None, [{"start": 0, "end": 1,
                                    "new_prompt": True}], 0.0, {}, None)
    assert harness.reader(name)(run) is None
    bare = _run([_kernel(0, 50)], [{"start": 0, "end": 1,
                                    "new_prompt": True}])
    assert harness.reader(name)(bare) is None


def test_the_metrics_read_a_traced_window():
    records = [{"start": 0, "end": 1, "new_prompt": True},
               {"start": 1, "end": 2, "new_prompt": False}]
    events = [_kernel(0, 50), _kernel(300, 400)]
    for name, a, b in [("atsm.separate_all_pcm", 40, 440),
                       ("atsm.pcm.assemble", 400, 430),
                       ("atsm.stream.block", 100, 150),
                       ("atsm.stream.block", 600, 700),
                       ("atsm.stream.feed", 90, 160),
                       ("atsm.model.text_tower", 500, 520),
                       ("atsm.data.wait", 60, 80),
                       ("atsm.train.step", 80, 300)]:
        events.append(_Ev(name, a, b))
    run = _run(events, records)
    got = {n: harness.reader(n)(run) for n in METRICS}
    assert got["pcm_idle_ms.serve"] == pytest.approx((250 + 40) * 1e-6 / 2)
    assert got["pcm_assemble_ms.serve"] == pytest.approx(30e-6 / 2)
    assert got["window_captures.serve"] == 0
    assert got["block_ms.stream"] == pytest.approx(150e-6 / 2)
    assert got["stream_idle_ms.stream"] == pytest.approx(70e-6 / 2)
    assert got["text_tower_ms.stream"] == pytest.approx(20e-6)
    assert got["batch_idle_ms.train"] == pytest.approx(20e-6 / 2)
    assert got["step_idle_ms.train"] == pytest.approx(220e-6 / 2)
