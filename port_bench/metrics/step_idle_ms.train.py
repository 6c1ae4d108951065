"""step_idle_ms: device idle time (ms) inside the program's
``atsm.train.step`` span (forward, backward, optimizer), a step
completed."""

from port_bench import spans


def read(run):
    return spans.idle_under_ms(run, ["atsm.train.step"], len(run.ok()))
