"""The sorts' share of their roofline: each row's key and payload read once
and written once, over the card's memory bandwidth, against the device's
busy time in the window (the sorts are all it runs)."""


def read(rec):
    if rec.trace is None or rec.peaks is None or not rec.items:
        return None
    busy = rec.trace.busy_s()
    least = 2 * rec.counters["row_bytes"] * rec.items / rec.peaks["hbm_bytes_per_s"]
    return 100 * least / busy if busy else None
