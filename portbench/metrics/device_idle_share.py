"""device_idle_share: the share of the traced calls' wall in which no
kernel, copy or set ran on the card."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
