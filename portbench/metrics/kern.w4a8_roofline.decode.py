"""B1/B2/B3's share of their roofline in decode: the least time of every
launch of the traced steps (``roofline.w4a8_step``) over their summed
device time, in %. Nothing where the trace holds fewer of their launches
than one a linear and one for the head each step (the program routes a
linear elsewhere at that batch, so the work could not be attributed)."""

from portbench import roofline, traceutil

PRIMARY = ("w4a8_mma_kernel", "w4a8_gateup_kernel")


def read(record):
    if record.get("kind") != "decode":
        return None
    spec, bits = roofline.of(record["config"])
    launched = sum(any(p in name for p in PRIMARY) for name, _, _ in record["events"])
    if launched != record["steps"] * (spec.layers * len(roofline.projections(spec)) + 1):
        return None
    by = traceutil.device_s_by_class(record["events"])
    device_s = by.get("B1/B3", 0.0) + by.get("B2", 0.0)
    if device_s <= 0:
        return None
    nbytes, ops = roofline.w4a8_step(spec, bits, record["batch"])
    return 100.0 * record["steps"] * roofline.bound_s(nbytes, ops) / device_s
