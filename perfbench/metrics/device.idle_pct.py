"""device.idle_pct (%). Layer: device. Source: device_trace. Moves: qps.
The share of the traced window in which no kernel, copy or set ran on
the card."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
