"""Each update deletes a label drawn uniformly from the live set."""


def pick(rng, live, params) -> int:
    return int(rng.integers(len(live)))
