"""Share of the window spent in evaluation passes (the driver's span around
each evaluation, which ends in its own read of the result)."""

LAYER = "evaluation"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "host_clock", "train_graphs_per_s"


def read(facts: dict):
    if "eval_s" not in facts:
        return None
    return 100.0 * facts["eval_s"] / facts["window_s"]
