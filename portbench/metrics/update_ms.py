"""The gradient step (forwards, loss, backward, optimizer) per update, from
the synchronized span around the runner's ``_update``."""


def read(rec):
    spans = rec.get("spans")
    update = spans and spans["spans"].get("update")
    if not update or not update["calls"]:
        return None
    return 1e3 * update["seconds"] / update["calls"]
