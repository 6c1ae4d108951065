"""henc_freq_fused_roofline_pct: the summed bound (bytes at 3.35 TB/s) of
the first frequency encoder layer the window ran through
ops.fused_enc.henc_freq_fused / the device time of its kernels in the
trace (henc_ and dconv:: names), in %."""

from port_bench import common
from port_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "henc_freq_fused", common.HENC_KERNELS)
