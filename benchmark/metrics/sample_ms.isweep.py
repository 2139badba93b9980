"""Mean ms a sweep spends in the program's span sweep.sample (each chunk's instance sampler, ending on a synchronize)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'sweep.sample')
