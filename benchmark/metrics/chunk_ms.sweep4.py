"""Mean ms of one program span sweep.chunk on rank 0 (one chunk of a sharded sweep, its gather included, host clock)."""

import spans


def read(run):
    return spans.span_ms_mean(run.records, spans.program_log(), 'sweep.chunk')
