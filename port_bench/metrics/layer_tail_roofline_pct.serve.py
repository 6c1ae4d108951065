"""layer_tail_roofline_pct: the summed bound (operations at the bf16 peak,
bytes at 3.35 TB/s) of the transformer layers the window ran through
ops.fused_attn.layer_tail / the device time of its kernels in the trace
(gemm_kernel<, flash_kernel, ln_kernel), in %."""

from port_bench import common
from port_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "layer_tail", common.LAYER_TAIL_KERNELS)
