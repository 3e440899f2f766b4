"""pytest settings of the benchmark's own tests: the ``card`` marker of
tests that need a CUDA card (they decide inside the test, and skip on a
machine without one)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
