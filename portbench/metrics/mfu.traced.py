"""The whole scan step's share of the chip's peak in the profiled window: the
model FLOPs of its transitions (``flops.py``) over the window's length,
against the peak of the configuration's precision."""


def read(rec):
    trace = rec.get("trace")
    if not trace or not trace["device_ops"]:
        return None
    flops = rec["flops_per_transition"] * trace["scan_steps"] * rec["num_envs"]
    return 100.0 * flops / trace["window_s"] / rec["peak_flops_per_s"]
