"""Shared fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): the card fixture that skips a card-only test where
there is none, and a cap on the CPU's threads."""

from __future__ import annotations

import pytest

@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
