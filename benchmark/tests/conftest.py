"""The benchmark's own tests (python -m pytest benchmark/tests). Those that
need the card carry the `cuda` marker and decide inside the test whether a
card is present."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")
