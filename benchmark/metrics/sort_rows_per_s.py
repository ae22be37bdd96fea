"""Rows sorted in the window over the window's wall time; each call ends in
a sync."""


def read(rec):
    return rec.items / rec.window_s if rec.items else None
