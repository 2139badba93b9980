"""Mean ms a request spends in the program's span scene.pipeline (uploads, the ingest pipeline on the device and its one transfer to the host)."""

import spans


def read(run):
    return spans.span_ms_per_request(run.records, spans.program_log(), 'scene.pipeline')
