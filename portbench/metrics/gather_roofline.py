"""The row gather's share of its bandwidth bound: for each of ``B`` rows the
stored uint8 frame and its successor slot's read once, with the id, action,
reward and the two episode flags, and the float32 frames, action, reward,
discount, terminal flag and weight written once, over the HBM bandwidth,
against the device time of every operation launched under the buffer's
``gather``, per call."""


def gather_bytes(batch: int, frame_bytes: int) -> int:
    read = 2 * frame_bytes + 4 + 4 + 4 + 1 + 1
    written = 2 * 4 * frame_bytes + 4 + 4 + 4 + 1 + 4
    return batch * (read + written)


def read(rec):
    trace = rec.get("trace")
    under = trace and trace["under"].get("gather")
    if not under or not under["calls"] or not under["device_s"]:
        return None
    bound_s = gather_bytes(rec["minibatch"], rec["frame_bytes"]) / rec["peak"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (under["device_s"] / under["calls"])
