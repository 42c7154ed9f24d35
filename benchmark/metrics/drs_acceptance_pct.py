"""Accepted over proposed samples in the window (the sampler's own
counters, DRS.accepted and DRS.proposed)."""
LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return 100.0 * facts["accepted"] / facts["proposed"] if facts["proposed"] else None
