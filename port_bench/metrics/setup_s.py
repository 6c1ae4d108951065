"""setup_s: process start to the first timed request (s): loading,
drawing the weights and traffic, the kernel gate, warm-up and captures."""


def read(run):
    return run.setup_s
