"""Device ms per decode step in ops that are not the port's hand kernels
(B1-B10 and their split-K reduces): norms, rope, q/k norms, the act
quantizers, residual adds, argmax, the graph's copies."""

from portbench import traceutil


def read(record):
    if record.get("kind") != "decode":
        return None
    glue = traceutil.device_s_by_class(record["events"]).get("glue")
    return None if glue is None else glue / record["steps"] * 1e3
