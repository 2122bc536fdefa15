# NOTE: no XLA_FLAGS / device-count overrides here — smoke tests and benches
# must see the real (single) device.  Only launch/dryrun.py (and the
# dedicated subprocess tests) force 512 host devices.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skips without one")
