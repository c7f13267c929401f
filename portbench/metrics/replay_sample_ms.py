"""Replay sampling per update: a prioritized buffer's ``sample`` (the draw
and the row gather), or a uniform ring's id draw (one per scan step) and row
gathers, from synchronized spans."""


def read(rec):
    spans = rec.get("spans")
    if not spans:
        return None
    s = spans["spans"]
    updates = s.get("update", {}).get("calls", 0)
    if not updates:
        return None
    if s.get("sample", {}).get("calls"):
        return 1e3 * s["sample"]["seconds"] / updates
    if s.get("sample_indices", {}).get("calls") and s.get("gather", {}).get("calls"):
        return 1e3 * (s["sample_indices"]["seconds"] + s["gather"]["seconds"]) / updates
    return None
