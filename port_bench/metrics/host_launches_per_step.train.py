"""host_launches_per_step: cudaLaunchKernel, cuLaunchKernel and
cudaGraphLaunch calls in the trace's host activity / steps completed."""

from port_bench.readers import launches_per


def read(run):
    return launches_per(run, "steps")
