"""A prioritized draw's share of its bandwidth bound: the least bytes the draw
needs (its ``C`` float32 leaf priorities read once, ``B`` int32 slots
written) over the HBM bandwidth, against the device time of every operation
launched under the buffer's ``draw``, per call."""


def draw_bytes(leaves: int, batch: int) -> int:
    return 4 * leaves + 4 * batch


def read(rec):
    trace = rec.get("trace")
    under = trace and trace["under"].get("draw")
    if not under or not under["calls"] or not under["device_s"] or not rec.get("tree_leaves"):
        return None
    bound_s = draw_bytes(rec["tree_leaves"], rec["minibatch"]) / rec["peak"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (under["device_s"] / under["calls"])
