"""Share of the window spent in the batched parameter casts of the bf16
forwards and of their backwards, the evaluations' included: the
program's ``nn.cast`` spans."""

LAYER = "train step"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "train_graphs_per_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = sum(r.end_ns - r.start_ns for r in records if r.name == "nn.cast")
    return 100.0 * ns / 1e9 / facts["window_s"]
