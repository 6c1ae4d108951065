"""train_samples_per_s: training samples of the completed steps / the
window wall; each step ends with its loss on the host."""

from port_bench.readers import rate


def read(run):
    return rate(run, "samples")
