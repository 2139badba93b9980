"""K2 (the row gather): share of its bound reached in the traced requests, %."""

import readers


def read(run):
    return readers.roofline(run, 'k2')
