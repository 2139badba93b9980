"""Device kernels on card 0 (rank 0's process) in the trace per base of the traced sweeps over the whole mesh: card 0 sweeps a quarter of those bases on four ranks."""

import readers


def read(run):
    return readers.kernels_per(run, 'base')
