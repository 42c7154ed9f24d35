"""The traced window's time in which no operation ran on the card, as a
share of the window (the union of the device's operation intervals)."""
from benchmark.harness import counts

LAYER, MOVES = "device", "drs_accepted_per_s"


def read(facts):
    return counts.idle_pct(facts)
