"""Priority feedback per update (the priorities from the errors, both trees
updated level by level), from the synchronized span around
``update_priorities``."""


def read(rec):
    spans = rec.get("spans")
    feedback = spans and spans["spans"].get("feedback")
    updates = spans and spans["spans"].get("update", {}).get("calls", 0)
    if not feedback or not feedback["calls"] or not updates:
        return None
    return 1e3 * feedback["seconds"] / updates
