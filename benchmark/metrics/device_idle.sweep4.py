"""Share of the traced window (host clock of rank 0's trace, ended by a synchronize) in which no operation ran on rank 0's card, %."""

import readers


def read(run):
    return readers.device_idle(run)
