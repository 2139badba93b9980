"""Mean ms of timings['congruent_sets'] + timings['rigid_fit'] a request."""

import readers


def read(run):
    return readers.mean_ms(run.records, lambda r: r.timings['congruent_sets'] + r.timings['rigid_fit'])
