"""setup_s (s, lower): process start to the first timed call: data,
the build, PCA, packing and the warm calls."""


def read(run):
    return run["setup_s"]
