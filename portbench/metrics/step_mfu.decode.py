"""The whole decode step's share of the chip: its least time, max(int8
ops / peak, bytes / HBM peak) with every weight read and every cache row
covered, over the traced window's wall time per step, in %."""

from portbench import roofline


def read(record):
    if record.get("kind") != "decode" or not record["events"] or record["window_s"] <= 0:
        return None
    spec, bits = roofline.of(record["config"])
    steps, batch = record["steps"], record["batch"]
    _, lin_ops = roofline.w4a8_step(spec, bits, batch)
    att_bytes, att_ops = roofline.attention(spec, bits, record["rows"], steps * batch)
    nbytes = steps * roofline.step_weights_bytes(spec, bits) + att_bytes
    least = roofline.bound_s(nbytes, steps * lin_ops + att_ops)
    return 100.0 * least / record["window_s"]
