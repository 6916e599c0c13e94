"""Share of the traced window in which the card ran nothing: one minus the
union of its kernel, copy and set intervals (user annotations left out)
over the window."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "score_p95_s"


def read(facts: dict):
    if "busy_s" not in facts:
        return None
    return 100.0 * (1.0 - facts["busy_s"] / facts["trace_window_s"])
