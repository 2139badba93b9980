"""The program's instance.flood_fills counter (flood fills launched) per request."""

import spans


def read(run):
    return spans.count_per_request(run.records, spans.program_log(), 'instance.flood_fills')
