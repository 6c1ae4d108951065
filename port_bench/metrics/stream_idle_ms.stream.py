"""stream_idle_ms: device idle time (ms) inside the program's
``atsm.stream.open``, ``atsm.stream.feed`` and ``atsm.stream.flush`` spans,
a session completed."""

from port_bench import spans


def read(run):
    return spans.idle_under_ms(
        run, ["atsm.stream.open", "atsm.stream.feed", "atsm.stream.flush"],
        len(run.ok()))
