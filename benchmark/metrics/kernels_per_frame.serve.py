"""Device kernels in the trace per traced request."""

import readers


def read(run):
    return readers.kernels_per(run, 'request')
