"""pcm_assemble_ms: the time (ms) of the program's ``atsm.pcm.assemble``
span, the groups' pieces copied into the song's int16 array, a song
completed."""

from port_bench import spans


def read(run):
    return spans.span_ms(run, ["atsm.pcm.assemble"], len(run.ok()))
