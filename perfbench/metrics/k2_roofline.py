"""K2's share of its roofline, %: the float32 map read and the uint8 tiles
written once each (``counts/work.py``), at the HBM peak, over its device time a request."""

PATTERN = "tanh_to_uint8"


def read(r):
    seconds = r.profile.device_s(pattern=PATTERN) / r.profile.units
    if seconds <= 0:
        return None
    return 100.0 * r.counts["k2_bytes"] / r.peaks["hbm_bytes_per_s"] / seconds
