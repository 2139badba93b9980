"""Mean ms of timings['icp_refine'] a request (requests whose winner was polished)."""

import readers


def read(run):
    return readers.mean_ms([r for r in run.records if 'icp_refine' in r.timings], lambda r: r.timings['icp_refine'])
