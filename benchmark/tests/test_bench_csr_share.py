"""``csr_share.train``: the ``collate.csr`` spans over the ``loader.collate``
spans, and nothing where a program records no ``collate.csr``."""

from __future__ import annotations

import pytest

from benchmark import run

S = 10 ** 9


def _span(name, start, end, sid, parent=None, thread="pamnet-prefetch"):
    from pamnet_tpu_torch.profiling import Span

    return Span(name, thread, 1, sid, parent, sid, start, end)


@pytest.fixture
def records(monkeypatch):
    from pamnet_tpu_torch import profiling

    def put(recs, dropped=0):
        monkeypatch.setattr(profiling, "_records", list(recs))
        monkeypatch.setattr(profiling, "_dropped", dropped)
    return put


COLLATIONS = [_span("loader.collate", 0, 2 * S, 1), _span("loader.collate", 2 * S, 3 * S, 2),
              _span("pipeline.stage", 0, 3 * S, 3, thread="pamnet-stage")]


@pytest.mark.parametrize("csr,want", [
    ([_span("collate.csr", S // 2, S, 4, 1)], 100.0 * 0.5 / 3),
    ([_span("collate.csr", S // 2, S, 4, 1), _span("collate.csr", 2 * S, 2 * S + S // 4, 5, 2)],
     100.0 * 0.75 / 3),
    ([_span("collate.csr", 0, 2 * S, 4, 1), _span("collate.csr", 2 * S, 3 * S, 5, 2)], 100.0),
])
def test_the_share_of_collation_spent_on_the_csr_arrays(csr, want, records):
    records(COLLATIONS + csr)
    assert run.metric_reader("csr_share.train").read({"window_s": 10.0}) == pytest.approx(want)


@pytest.mark.parametrize("recs,dropped", [
    ([], 0),  # an untraced run
    (COLLATIONS, 0),  # a program without the span: nothing, not 0
    ([_span("collate.csr", 0, S, 4)], 0),  # no collation
    (COLLATIONS + [_span("collate.csr", 0, S, 4, 1)], 1),  # spans the recorder could not hold
])
def test_nothing_to_read_gives_nothing(recs, dropped, records):
    records(recs, dropped)
    assert run.metric_reader("csr_share.train").read({"window_s": 10.0}) is None
