"""Shared pytest settings: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's hand-written kernels); "
        "skipped with a reason where there is none")
