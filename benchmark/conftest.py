"""pytest settings of the benchmark's own tests (``benchmark/tests/``):
the ``cuda`` marker, and a session-wide cache of trees and of the tree
generator's build outside the checkout."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; decides inside the test whether "
        "one is present and skips if not")


@pytest.fixture(scope="session", autouse=True)
def tree_cache(tmp_path_factory):
    from benchmark import trees

    saved = trees.CACHE
    trees.CACHE = tmp_path_factory.mktemp("bench_cache")
    yield trees.CACHE
    trees.CACHE = saved
