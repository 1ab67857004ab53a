"""verify.device_idle: the share of the traced window in which no operation
ran on the card (1 - the union of the device intervals), in percent."""


def read(record):
    trace = record["trace"]
    if record["kind"] != "verify" or trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
