"""pytest settings of the benchmark's own tests (run them with
`python -m pytest portbench/tests -q` from the repository's root).

Tests marked `card` need a CUDA card; each decides so inside its fixture
and skips there, never while the module is imported."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
