"""Mean ms of a request outside every top-level program span."""

import spans


def read(run):
    return spans.untraced_ms(run.records, spans.program_log())
