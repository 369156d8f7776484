"""The work every implementation of a step must do, from its shapes: the
raw scenes read once, the class maps written once and the forest's tables
read once; the operations are the forest's node comparisons these pixels
need (zero for the rule method, which runs no model).

A step: ``{"raw_bytes": .., "map_bytes": .., "table_bytes": ..,
"comparisons": ..}``."""


def count(step: dict):
    return (step["raw_bytes"] + step["map_bytes"] + step["table_bytes"],
            step["comparisons"])
