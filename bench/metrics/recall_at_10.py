"""Recall@10 over every query answered in the window, against the exact
top-10 over the live (and allowed) set it was served against; a label
within ``TIE_RTOL`` of the 10th exact distance counts as a hit."""


def read(obs):
    if not obs.readings or not obs.readings["rows"]:
        return None
    return 1.0 - obs.readings["recall_miss"]
