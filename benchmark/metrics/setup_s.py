"""Seconds from the process's start to the window's start: imports, card
initialisation, data and weights from the seed, the program's set-up and
its warm-up (in a cell's first run in a checkout, the kernels' build)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(facts: dict):
    return facts.get("setup_s")
