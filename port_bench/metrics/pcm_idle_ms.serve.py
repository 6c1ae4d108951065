"""pcm_idle_ms: device idle time (ms) inside the program's
``atsm.separate_all_pcm`` span (the host's own work in the call: the peak,
staging, the wait and the int16 array), a song completed."""

from port_bench import spans


def read(run):
    return spans.idle_under_ms(run, ["atsm.separate_all_pcm"], len(run.ok()))
