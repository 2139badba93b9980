"""Mean ms a sweep spends in the program's span sampling.exists_bits (host time of the existence-matrix build)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'sampling.exists_bits')
