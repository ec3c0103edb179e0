"""build.link_s (s). Layer: core.build. Source: program_span. Moves:
setup_s. The wave builder's host linking (``timings["link"]``)."""


def read(run):
    return run["build"].get("link")
