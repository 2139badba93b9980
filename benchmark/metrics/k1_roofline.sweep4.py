"""K1 (the congruent dense gate): share of its bound reached on rank 0's card in the traced requests, %."""

import readers


def read(run):
    return readers.roofline(run, 'k1')
