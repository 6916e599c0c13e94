"""The least time of the window's message-passing work at the card's
memory bandwidth (its bytes from ``counts/``, each input read once and
each output written once, over 3.35 TB/s) over the device time of the
port's kernels (``counts/port_kernels*.json``) in the traced window."""

from benchmark.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_graphs_per_s"


def read(facts: dict):
    if not facts.get("port_kernel_s") or "mp_bytes" not in facts:
        return None
    return 100.0 * facts["mp_bytes"] / HBM_BYTES_PER_S / facts["port_kernel_s"]
