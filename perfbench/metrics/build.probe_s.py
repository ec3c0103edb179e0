"""build.probe_s (s). Layer: core.build. Source: program_span. Moves:
setup_s. The wave builder's device probe up to its results on the host
(``timings["probe"]``)."""


def read(run):
    return run["build"].get("probe")
