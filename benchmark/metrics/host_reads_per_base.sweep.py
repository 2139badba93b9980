"""The program's host_reads counter over the bases of the window's sweeps."""

import spans


def read(run):
    return spans.count_per_base(run.records, spans.program_log(), 'host_reads')
