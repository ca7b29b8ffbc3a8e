"""Face frames decoded and scored to logits a second over the window's
wall outside its traced slice (whole passes; the profiler slows the slice
it traces): the dense pass as its user waits for it, on the host's clock."""


def read(record):
    frames = record.get("count", 0) - record.get("traced_count", 0)
    seconds = record.get("untraced_s", 0)
    return frames / seconds if frames > 0 and seconds > 0 else None
