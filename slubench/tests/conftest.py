"""Fixtures of the benchmark's tests (the cells are in ``slubench_cells.py``)."""

import pytest

from slubench_cells import tiny_cell


@pytest.fixture
def tiny(tmp_path):
    return lambda name: tiny_cell(name, str(tmp_path / name))
