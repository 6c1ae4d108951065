"""window_captures: times the program's ``atsm.program.capture`` span ran
inside the window: a chunk program warmed and captured again after set-up
(expected 0)."""

from port_bench import spans


def read(run):
    return spans.occurrences(run, "atsm.program.capture")
