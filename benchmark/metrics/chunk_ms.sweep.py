"""Mean ms of one program span sweep.chunk (one chunk of a sweep, host clock)."""

import spans


def read(run):
    return spans.span_ms_mean(run.records, spans.program_log(), 'sweep.chunk')
