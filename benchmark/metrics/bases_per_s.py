"""Bases of every sweep completed in the window over the window's time."""

import readers


def read(run):
    return sum(r.bases for r in run.records) / run.window_s if run.window_s > 0 else None
