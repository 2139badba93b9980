"""Device kernels in the trace per base of the traced sweeps."""

import readers


def read(run):
    return readers.kernels_per(run, 'base')
