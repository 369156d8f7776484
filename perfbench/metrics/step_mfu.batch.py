"""The whole step's share of the card's peak, in %: the least time of the
work every implementation must do for a unit (``counts/step.py``) over the
measured time per unit of the window."""

from perfbench.harness.roofline import step_share


def read(rec):
    return step_share(rec)
