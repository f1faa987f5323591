"""The window's wall time over the requests completed in it, in ms."""


def read(rec):
    return 1e3 * rec["window_s"] / len(rec["requests"]) if rec["requests"] else None
