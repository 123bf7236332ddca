"""reserved_gib.train: the caching allocator's reserved bytes
(``torch.cuda.memory_reserved``) at the end of each training step, as the
program's ``train.step`` span records them; the largest over the
``busy_steps`` steps traced with device activity only (``spans.py``), in
GiB."""

from portbench import spans


def read(ctx):
    reserved = spans.largest_attribute(ctx, "reserved_bytes")
    return None if reserved is None else reserved / 2 ** 30
