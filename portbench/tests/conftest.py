"""Settings of the benchmark's own tests (run: python -m pytest
portbench/tests). Tests that need a card carry the `cuda` marker and
skip inside the test where none is present."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    # the runs here are small: a few host threads each, so that several
    # test workers do not crowd the host
    import torch
    torch.set_num_threads(2)
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
