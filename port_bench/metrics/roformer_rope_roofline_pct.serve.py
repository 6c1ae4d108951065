"""roformer_rope_roofline_pct: the summed bound (bytes at 3.35 TB/s;
``roformer_work.rope_work``) of the RoPE launches the window ran through
ops.fused_rope.rope_qkv, at their shapes, / the device time of
rope_qkv_kernel in the trace, in %.  The launches are the program's
``rope_qkv`` counter, held against the driver's copy of the group
schedule; None where rope_qkv did not launch (a program without it)."""

from port_bench import roformer_share


def read(run):
    return roformer_share.read(run, "rope_qkv", ("rope_qkv_kernel",))
