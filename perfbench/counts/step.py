"""The work every implementation of a step must do, from its shapes: the
raw scenes read once, the class maps written once and the forest's tables
read once; the operations are the reference's for these pixels, as the
configuration's reference counts them (``harness/check.py``): node
comparisons for a forest, 0 for the rules, which run no model.

A step: ``{"raw_bytes": .., "map_bytes": .., "table_bytes": ..,
"ops": ..}``."""


def count(step: dict):
    return (step["raw_bytes"] + step["map_bytes"] + step["table_bytes"],
            step["ops"])
