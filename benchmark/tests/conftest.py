"""The benchmark's CPU tests: ``python3 -m pytest benchmark/tests -q``.

Tests that need the card carry the ``cuda`` marker and skip inside the
test where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped inside the test without one")
