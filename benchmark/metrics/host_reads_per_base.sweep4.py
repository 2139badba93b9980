"""Rank 0's host_reads counter over the bases of the window's sweeps over the whole mesh: rank 0 sweeps a quarter of those bases on four ranks."""

import spans


def read(run):
    return spans.count_per_base(run.records, spans.program_log(), 'host_reads')
