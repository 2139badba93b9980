"""Mean ms a request spends in the program's span scene.build (both neighbour grids and the dense field on the host, and their uploads)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'scene.build')
