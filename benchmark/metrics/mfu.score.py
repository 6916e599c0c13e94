"""The model's FLOPs of the forwards the service ran in the window
(``counts/``) over the window's seconds times the card's published peak
for the configuration's compute type (``peaks.py``)."""

LAYER = "model forward"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "score_p95_s"


def read(facts: dict):
    if "flops" not in facts or "scored" not in facts:
        return None
    return 100.0 * facts["flops"] / (facts["window_s"] * facts["peak_flops"])
