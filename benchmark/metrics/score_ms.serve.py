"""Mean ms of timings['scoring'] a request."""

import readers


def read(run):
    return readers.mean_ms(run.records, lambda r: r.timings['scoring'])
