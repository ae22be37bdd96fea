"""The window's wall time over the queries completed in it (one closed-loop
client)."""


def read(rec):
    return 1e3 * rec.window_s / rec.completed if rec.completed else None
