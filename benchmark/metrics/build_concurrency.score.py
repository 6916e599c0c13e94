"""Graph builds in flight while any build runs: the program's
``loader.build`` spans, the sum of their durations over the length of the
union of their intervals (1 where builds never overlap, as under a lock
held across the build; up to the number of handler threads building at
once)."""

LAYER = "HTTP service"
UNIT, BETTER, SOURCE, MOVES = "builds", "higher", "program_span", "score_p95_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    builds = sorted((r.start_ns, r.end_ns) for r in records if r.name == "loader.build")
    total = union = end = 0
    for start, stop in builds:
        total += stop - start
        union += max(0, stop - max(start, end))
        end = max(end, stop)
    if not union:
        return None
    return total / union
