"""Device operations (kernels, copies, fills) launched per transition in the
profiled window."""


def read(rec):
    trace = rec.get("trace")
    if not trace or not trace["device_ops"]:
        return None
    return trace["device_ops"] / (trace["scan_steps"] * rec["num_envs"])
