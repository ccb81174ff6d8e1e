"""The step's W4A8 linears' share of their roofline in decode: the least
time of every launch of the traced steps (the family's
``Counters.linears``: B1/B2/B3 by default) over the device time of their
kernel classes, in %. Nothing where the trace holds another number of
their primary launches than ``Counters.linear_launches`` a step (the
program routes a linear elsewhere at that batch, so the work could not be
attributed)."""

from portbench import roofline, traceutil


def read(record):
    if record.get("kind") != "decode":
        return None
    c = roofline.of(record["config"])
    launched = traceutil.launches(record["events"], of=c.LINEAR_CLASSES)
    if launched != record["steps"] * c.linear_launches():
        return None
    by = traceutil.device_s_by_class(record["events"])
    device_s = sum(by.get(k, 0.0) for k in c.LINEAR_CLASSES)
    if device_s <= 0:
        return None
    nbytes, ops = c.linears(record["batch"])
    return 100.0 * record["steps"] * roofline.bound_s(nbytes, ops) / device_s
