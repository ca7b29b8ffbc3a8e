"""The share of the window that the training loop spent waiting on the
host feed: ``train/engine``'s own ``feed_wait_s`` summed over the
window's epochs outside the traced slice, over the time outside it."""


def read(record):
    if "free_feed_wait_s" not in record or record.get("untraced_s", 0) <= 0:
        return None
    return record["free_feed_wait_s"] / record["untraced_s"]
