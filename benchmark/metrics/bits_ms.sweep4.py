"""Mean ms a sweep spends in the program's span sampling.exists_bits on rank 0 (host time of rank 0's existence-matrix build; every process builds its own)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'sampling.exists_bits')
