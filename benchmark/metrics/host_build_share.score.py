"""Share of the window the service spent building graphs and collating on
the host: the driver's spans, in the traced run, around the construction
and the collations of the ``GraphLoader`` that ``serve.py`` binds."""

LAYER = "host graph build and collation"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "host_clock", "score_p95_s"


def read(facts: dict):
    if "host_build_s" not in facts:
        return None
    return 100.0 * facts["host_build_s"] / facts["window_s"]
