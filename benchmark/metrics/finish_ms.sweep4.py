"""Mean ms a sweep spends on rank 0 in the program's span sweep.finish (finish_sweep_pool: ICP polish and clustering)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'sweep.finish')
