"""B4's share of its roofline in decode: the least time of the cache rows
the traced steps cover, q, out and the appended rows (the family's
``Counters.attention``) over B4's device time, in %."""

from portbench import roofline, traceutil


def read(record):
    if record.get("kind") != "decode":
        return None
    device_s = traceutil.device_s_by_class(record["events"]).get("B4", 0.0)
    if device_s <= 0:
        return None
    c = roofline.of(record["config"])
    nbytes, ops = c.attention(record["rows"], record["steps"] * record["batch"])
    return 100.0 * roofline.bound_s(nbytes, ops) / device_s
