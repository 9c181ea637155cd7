"""Update rows drawn from the configuration's fixed mixture (the same 32
clusters as the build's rows), chunk ``c`` from its own seed stream."""
from bench.reference import data as D


def rows(seed, chunk, n, d, params):
    return D.draw(n, d, seed, D.UPDATE_ROWS + chunk)
