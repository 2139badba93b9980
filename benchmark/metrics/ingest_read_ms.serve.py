"""Mean ms a request spends in the program's span scene.read (the PNG decode of load_scene)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'scene.read')
