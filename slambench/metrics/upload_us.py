"""io (``runner.run_frames``): device µs a frame that a frame's upload from the
host holds the card's queue, from a stamp before its first copy to one after
its last (the pageable copies, the depth's rectification and the host's turns
between them), without the wait for the replay before, which the host span
``frame.upload`` holds besides; over the uploaded frames past each sequence's
first in the sequences that ran no profiler (``RunStats.upload_device_us``)."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "upload_device_us", frames="upload_frames")
