"""The benchmark's own tests: CPU at tiny sizes, and card tests marked
``cuda`` that skip without one (decided in a fixture, never at import).

    python -m pytest -q benchmark/tests            # here
    python -m pytest -q -m cuda benchmark/tests    # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return "cuda"
