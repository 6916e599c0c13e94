"""Share of the service's graph builds spent on the host spherical basis:
the program's ``build.basis`` spans over its ``loader.build`` spans."""

LAYER = "host graph build and collation"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "score_p95_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = {name: 0 for name in ("build.basis", "loader.build")}
    for r in records:
        if r.name in ns:
            ns[r.name] += r.end_ns - r.start_ns
    if not ns["loader.build"]:
        return None
    return 100.0 * ns["build.basis"] / ns["loader.build"]
