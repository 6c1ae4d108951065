"""mfu: operations the window's completed work needs, counted on the plain
reference at the cell's shapes, / the window wall / 989e12 (bf16, H100
SXM data sheet), in %."""

from port_bench.readers import mfu_pct as read  # noqa: F401
