"""Share of the service's request time spent waiting for its lock: the
program's ``serve.lock_wait`` spans over its ``serve.request`` spans (each
POST from its body's read to its reply's write)."""

LAYER = "HTTP service"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_span", "score_p95_s"


def read(facts: dict):
    from pamnet_tpu_torch import profiling

    records = profiling.spans() if hasattr(profiling, "spans") else []
    if not records or profiling.dropped():
        return None  # no recorder in the program, nothing recorded, or spans it could not hold
    ns = {name: 0 for name in ("serve.lock_wait", "serve.request")}
    for r in records:
        if r.name in ns:
            ns[r.name] += r.end_ns - r.start_ns
    if not ns["serve.request"]:
        return None
    return 100.0 * ns["serve.lock_wait"] / ns["serve.request"]
