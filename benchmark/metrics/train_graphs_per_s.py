"""Training graphs completed per second: the graphs of every training step
of the window over the window's seconds (evaluation passes count as time)."""

UNIT, BETTER, SOURCE = "graphs/s", "higher", "host_clock"


def read(facts: dict):
    if "graphs" not in facts:
        return None
    return facts["graphs"] / facts["window_s"]
