"""Share of the traced decode call's wall time with no device op running, in %."""


def read(record):
    if record.get("kind") != "decode" or not record["events"] or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
