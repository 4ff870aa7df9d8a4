"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that need the card and skip without one."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skips without one")
