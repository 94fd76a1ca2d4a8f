"""``frame_fill.*``: the padded frames that hold any kept point over all
the frames the program runs (``ococcnet.frames_nonempty`` /
``ococcnet.frame_slots``), in %: the temporal transformer and the occupancy
decoder run over every frame slot."""
from portbench.spans import fill

# the program counters this reads: (useful, slots)
SOURCE = ("ococcnet.frames_nonempty", "ococcnet.frame_slots")


def read(ctx):
    return fill("ococcnet.frames_nonempty", "ococcnet.frame_slots")
