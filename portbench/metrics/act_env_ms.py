"""Acting (the network's forward and the explorer) and the env step, per
scan step, from the synchronized spans around ``select_action`` and
``env.step``."""


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans["scan_steps"]:
        return None
    s = spans["spans"]
    if "act" not in s or "env" not in s:
        return None
    return 1e3 * (s["act"]["seconds"] + s["env"]["seconds"]) / spans["scan_steps"]
