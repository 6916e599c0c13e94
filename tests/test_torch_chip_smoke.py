"""``chip_smoke.py``'s one table of expected launches, read on the CPU: it
counts every kernel wrapper of the port, and the rule that holds each path's
counts to it.  The counts themselves are read on the card."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import importlib
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_launch_table_counts_every_kernel_wrapper():
    """The script reads the launches of every wrapper of ``pamnet_tpu_torch/
    ops/`` that counts them, each path's expectations name only those, and
    the wrappers that no path wants (no count above 0, no "at least one")
    are the two one-gradient routes of kernel A's backward."""
    smoke = _chip_smoke()
    counted = {}
    for path in sorted((ROOT / "pamnet_tpu_torch" / "ops").glob("*.py")):
        module = importlib.import_module(f"pamnet_tpu_torch.ops.{path.stem}")
        counted.update({name: fn for name, fn in vars(module).items()
                        if callable(fn) and hasattr(fn, "launches")})
    assert smoke.wrappers() == counted
    wanted = set()
    for name, (fwd, bwd) in smoke.LAUNCHES.items():
        assert fwd and set(fwd) | set(bwd) <= set(counted), name
        wanted |= {k for want in (fwd, bwd) for k, v in want.items() if v != 0}
    assert set(counted) - wanted == {"triplet_aggregate_grad_a", "gather_product"}


def test_held_reads_exact_counts_at_least_one_and_the_split_rule():
    """A named count is exact, None asks for at least one, an unnamed count
    is free, and where group sums are named not all of them may take the
    split kernel."""
    held = _chip_smoke()._held
    counts = {"triplet_aggregate": 3, "row_gather": 0, "edge_message": 5, "group_sum": 2,
              "group_sum_split": 1}
    assert held(counts, {"triplet_aggregate": 3, "row_gather": 0, "edge_message": None})
    assert not held(counts, {"triplet_aggregate": 2})
    assert not held(counts, {"row_gather": None})
    assert held(counts, {"group_sum": None})
    assert not held({**counts, "group_sum_split": 2}, {"group_sum": None})
    assert held({**counts, "group_sum_split": 2}, {"triplet_aggregate": 3})
