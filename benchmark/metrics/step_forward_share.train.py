"""Share of the window the step thread spent in the steps' forwards and
losses, the parameter cast included: the program's ``step.forward``
spans."""

LAYER = "train step"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "train_graphs_per_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = sum(r.end_ns - r.start_ns for r in records if r.name == "step.forward")
    return 100.0 * ns / 1e9 / facts["window_s"]
