"""The model's FLOPs of the window's training steps and evaluation passes
(``counts/``) over the window's seconds times the card's published peak
for the configuration's compute type (``peaks.py``)."""

LAYER = "train step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_graphs_per_s"


def read(facts: dict):
    if "flops" not in facts or "graphs" not in facts:
        return None
    return 100.0 * facts["flops"] / (facts["window_s"] * facts["peak_flops"])
