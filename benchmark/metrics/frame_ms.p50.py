"""Median time from a frame's files to its pose(s), ms, over the window's requests."""

import readers


def read(run):
    return readers.frame_ms(run.records, 50)
