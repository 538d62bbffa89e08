"""Process start to the first timed call: imports, weights, the system's
build and kernel loads, warm-up."""


def read(run):
    return run["setup_s"]
