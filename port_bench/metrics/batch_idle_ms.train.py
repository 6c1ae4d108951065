"""batch_idle_ms: device idle time (ms) inside the program's
``atsm.data.wait`` (the step waiting for the loader's batch) and
``atsm.train.put_batch`` (the batch's copies to the card) spans, a step
completed."""

from port_bench import spans


def read(run):
    return spans.idle_under_ms(run, ["atsm.data.wait", "atsm.train.put_batch"],
                               len(run.ok()))
