"""Mean ms of StocsResult.timings['sample_bases'] a request."""

import readers


def read(run):
    return readers.mean_ms(run.records, lambda r: r.timings['sample_bases'])
