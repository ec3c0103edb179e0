"""search.trips_per_call (count). Layer: core.search_torch. Source:
program_counter. Moves: qps. Layer-body trips a call of the window
(``search_torch.trip_counts()["layer"]``): the host work of the search
goes by trips, whatever the batch."""


def read(run):
    return run["trips"] if run["calls"] else None
