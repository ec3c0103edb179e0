"""serve.self_ms_per_call (ms). Layer: serve.vector_service. Source:
program_span. Moves: qps. The mean over the window's calls of the
``serve.query`` span less its ``search`` child: validation, the host's
``filt.prepare``, the copy of the answers to the host and the wait for
the last trips, the latency histogram."""


def read(run):
    roots = [s for s in run.get("spans", []) if s.name == "serve.query"]
    if not roots:
        return None
    self_ms = [r.duration_ms - sum(c.duration_ms for c in r.children)
               for r in roots]
    return sum(self_ms) / len(self_ms)
