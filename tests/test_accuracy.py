"""Accuracy-harness test tier (SURVEY.md §7.3 item 1, §4 item 5).

Runs the quick sweep grid from scripts/accuracy_sweep.py inside pytest:
recall/precision floors on simulated truth with honest error processes
(subs + indels + skips).
The full grid runs out-of-band (see BASELINE.md accuracy table).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "accuracy_sweep",
    os.path.join(os.path.dirname(__file__), "..", "scripts",
                 "accuracy_sweep.py"),
)
sweep = importlib.util.module_from_spec(_spec)
sys.modules["accuracy_sweep"] = sweep  # dataclasses resolve via sys.modules
_spec.loader.exec_module(sweep)


def test_quick_grid_floors():
    """Every quick-grid cell must clear recall/precision floors; misses and
    spurious calls beyond the adjacent-shift ambiguity mode are bugs."""
    for cell in sweep.QUICK_GRID:
        m, _ = sweep.run_cell(cell, "scan", seed=7)
        assert m["n_anchored"] >= 0.95 * m["n_reads"], m
        assert m["recall"] >= 0.80, f"recall floor: {m}"
        assert m["precision"] >= 0.75, f"precision floor: {m}"
        # non-shift false calls: at most 1 per cell
        assert m["fp"] - m["n_shifted"] <= 1, f"unexplained FPs: {m}"
