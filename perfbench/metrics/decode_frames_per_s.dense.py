"""Face frames the port's decoder (``data/native_faces``) alone decodes,
crops, grays and resizes a second, at the extractor's thread count, over
the cell's files, timed by the dense driver after the traced slice."""


def read(record):
    return record.get("decode_frames_per_s")
