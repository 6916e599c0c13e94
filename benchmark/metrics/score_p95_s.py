"""The 95th percentile of the latencies of every request completed in the
window, each timed by its client from send to the whole reply."""

import numpy as np

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(facts: dict):
    lat = facts.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95))
