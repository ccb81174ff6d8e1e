"""The whole decode step's share of the chip: its least time, max(int8
ops / peak, bytes / HBM peak) with every weight read and every cache row
covered (the family's ``Counters``), over the traced window's wall time
per step, in %."""

from portbench import roofline


def read(record):
    if record.get("kind") != "decode" or not record["events"] or record["window_s"] <= 0:
        return None
    c = roofline.of(record["config"])
    steps, batch = record["steps"], record["batch"]
    _, lin_ops = c.linears(batch)
    att_bytes, att_ops = c.attention(record["rows"], steps * batch)
    nbytes = steps * c.weights_bytes() + att_bytes
    least = roofline.bound_s(nbytes, steps * lin_ops + att_ops)
    return 100.0 * least / record["window_s"]
