"""Mean ms a sweep spends in the program's spans sweep.chunk less its spans sweep.sample: congruent, fit and score at the chunk's width (host clock)."""

import spans


def read(run):
    log = spans.program_log()
    chunks = spans.span_ms_per_request(run.records, log, 'sweep.chunk')
    sample = spans.span_ms_per_request(run.records, log, 'sweep.sample')
    return None if chunks is None or sample is None else chunks - sample
