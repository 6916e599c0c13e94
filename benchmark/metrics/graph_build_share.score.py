"""Share of the window the service spent building graphs and collating on
the host, measured inside the program: its ``loader.build`` and
``loader.collate`` spans (``host_build_share.score`` times the same calls
from the harness)."""

LAYER = "host graph build and collation"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "score_p95_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = sum(r.end_ns - r.start_ns for r in records if r.name in ("loader.build", "loader.collate"))
    return 100.0 * ns / 1e9 / facts["window_s"]
