"""90th percentile of the window's request latencies, ms."""

import readers


def read(run):
    return readers.frame_ms(run.records, 90)
