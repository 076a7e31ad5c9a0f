"""device_idle.train: the share of the traced slice of a training cell
in which no operation ran on the device."""


def read(s: dict):
    if not s.get("train") or not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
