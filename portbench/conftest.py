"""The benchmark's tests: the `cuda` marker for those that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
