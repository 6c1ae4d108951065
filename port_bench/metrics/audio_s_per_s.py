"""audio_s_per_s: mixture seconds x stems returned, summed over the
requests completed in the window, / the window wall (first start to the
end of the last request that started inside it): bench.py's convention."""

from port_bench.readers import rate


def read(run):
    return rate(run, "audio_s")
