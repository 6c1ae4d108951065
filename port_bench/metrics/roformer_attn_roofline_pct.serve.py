"""roformer_attn_roofline_pct: the summed bound (operations at the bf16
peak, bytes at 3.35 TB/s; ``roformer_work.gated_attn_work``) of the gated
attention launches the window ran through ops.fused_attn.attn_gated, at
their shapes, / the device time of their kernels in the trace
(flash_kernel, gemm_kernel<), in %.  The launches are the program's
``attn_gated`` counter, held against the driver's copy of the group
schedule.  In the BS-RoFormer cell nothing else launches flash_kernel or
gemm_kernel< (no layer_tail or attn_block runs there), which this reader
relies on; None where attn_gated did not launch (a program without it)."""

from port_bench import roformer_share


def read(run):
    return roformer_share.read(run, "attn_gated",
                               ("flash_kernel", "gemm_kernel<"))
