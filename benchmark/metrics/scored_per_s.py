"""Structures scored with a 200 reply inside the window, over its seconds."""

UNIT, BETTER, SOURCE = "structures/s", "higher", "host_clock"


def read(facts: dict):
    if "scored" not in facts:
        return None
    return facts["scored"] / facts["window_s"]
