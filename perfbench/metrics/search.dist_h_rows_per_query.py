"""search.dist_h_rows_per_query (count). Layer: core.search_torch. Source:
program_counter. Moves: qps. Mean ``dist_h_evals`` of the counting call
(``search_batched(..., return_stats=True)`` on one batch of the window's
queries after the window): high-dimensional rows read a query."""


def read(run):
    c = run.get("counts")
    return c["dist_h_evals"] / c["queries"] if c else None
