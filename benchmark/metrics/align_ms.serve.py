"""Mean ms a request spends in the program's span multi.align (align_models and its checks)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'multi.align')
