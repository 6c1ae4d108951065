"""host_launches_per_chunk: cudaLaunchKernel, cuLaunchKernel and
cudaGraphLaunch calls in the trace's host activity / chunks computed
(bucket padding included)."""

from port_bench.readers import launches_per


def read(run):
    return launches_per(run, "computed")
