"""Mean ms of one program span sweep.gather on rank 0 (a chunk's gather of the ranks' pools through their reduction; across processes it ends on a host copy, so it holds the wait for the slowest process and the exchange)."""

import spans


def read(run):
    return spans.span_ms_mean(run.records, spans.program_log(), 'sweep.gather')
