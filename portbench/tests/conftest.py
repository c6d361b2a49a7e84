"""pytest settings of the benchmark's own tests (run from the repository's
root: python -m pytest portbench/tests)."""

import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips where there is none")
