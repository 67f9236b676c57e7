"""device_idle.train: the share of the traced window in which no device
operation ran (one minus the union of the operations' intervals over the
window), in percent."""


def read(record):
    if record.window_s <= 0 or not record.device_ops:
        return None
    return 100.0 * (1.0 - record.busy_s / record.window_s)
