"""Share of the window the staging thread spent on batches (pinning, the
copies' issue and the wait for them): the program's ``pipeline.stage``
spans."""

LAYER = "epoch pipeline"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "train_graphs_per_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = sum(r.end_ns - r.start_ns for r in records if r.name == "pipeline.stage")
    return 100.0 * ns / 1e9 / facts["window_s"]
