"""Share of the traced window (host clock of the trace, ended by a synchronize) in which no operation ran on the device, %."""

import readers


def read(run):
    return readers.device_idle(run)
