"""Mean ms a request spends in match_all_objects."""

import readers


def read(run):
    return readers.mean_ms(run.records, lambda r: r.multi_s)
