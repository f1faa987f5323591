"""MB of host arrays that bell_from_arrays hands to the device per call:
the port's counter bell.upload_bytes over the calls of its span
bell.upload."""

from portbench.metrics._program_spans import table


def read(rec):
    t = table()
    sent, uploads = t.get("bell.upload_bytes"), t.get("bell.upload")
    if not sent or not uploads or not uploads[0]:
        return None
    return sent[1] / uploads[0] / 1e6
