"""``point_fill.*``: the points the program's layout keeps over its point
slots (``ococcnet.points_kept`` / ``ococcnet.point_slots``, counted where
the SIR encoders take the layout), in %."""
from portbench.spans import fill

# the program counters this reads: (useful, slots)
SOURCE = ("ococcnet.points_kept", "ococcnet.point_slots")


def read(ctx):
    return fill("ococcnet.points_kept", "ococcnet.point_slots")
