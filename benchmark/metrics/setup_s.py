"""Seconds from process start to the start of the window: frames, preprocessing, loading, kernel builds and warm-up."""

import readers


def read(run):
    return run.setup_s
