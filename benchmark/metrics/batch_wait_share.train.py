"""Share of the window in which the step thread waited for its next batch
(the program's ``run_epoch(stats=)`` counter ``queue_wait_s``, summed over
the window's epochs)."""

LAYER = "epoch pipeline"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_counter", "train_graphs_per_s"


def read(facts: dict):
    if "queue_wait_s" not in facts:
        return None
    return 100.0 * facts["queue_wait_s"] / facts["window_s"]
