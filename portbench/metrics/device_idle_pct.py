"""The share of the profiled window in which no device operation ran (the
union of their intervals)."""


def read(rec):
    trace = rec.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
