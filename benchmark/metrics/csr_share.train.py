"""Share of the training batches' collation spent on their CSR arrays (the
sorted fields' offsets and the backward's permutations): the program's
``collate.csr`` spans over its ``loader.collate`` spans."""

LAYER = "host graph build and collation"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "train_graphs_per_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = {name: 0 for name in ("collate.csr", "loader.collate")}
    seen = set()
    for r in records:
        if r.name in ns:
            ns[r.name] += r.end_ns - r.start_ns
            seen.add(r.name)
    if seen != set(ns):
        return None  # a program without the span, or no collation in the window
    return 100.0 * ns["collate.csr"] / ns["loader.collate"]
