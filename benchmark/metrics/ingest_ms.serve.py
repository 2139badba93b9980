"""Mean ms a request spends in load_scene / load_scene_multi (span ended by a device synchronize)."""

import readers


def read(run):
    return readers.mean_ms(run.records, lambda r: r.ingest_s)
