"""The program's host_reads counter (explicit device-to-host reads) per request."""

import spans


def read(run):
    return spans.count_per_request(run.records, spans.program_log(), 'host_reads')
