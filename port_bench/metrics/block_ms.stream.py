"""block_ms: the time (ms) of the program's ``atsm.stream.block`` spans (a
block's program, its carry and its piece to the host) / the blocks run:
the inside counterpart of stream_step_ms."""

from port_bench import spans


def read(run):
    return spans.span_ms(run, ["atsm.stream.block"],
                         spans.occurrences(run, "atsm.stream.block"))
