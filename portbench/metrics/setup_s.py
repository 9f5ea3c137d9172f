"""Seconds from the process's start to the first timed call: imports, the
card's start, the kernel library's load, the inputs and one warm call."""


def read(run):
    return run.setup_s
