"""The bytes the program's collectives moved between cards over the traced
window (``collectives.PEER_BYTES``), in GB (1e9 bytes), over the device
seconds of the copies between two cards (the profiler's peer-to-peer
memcpy, summed over the cards)."""

COPIES = r"Memcpy PtoP"


def read(rec):
    nbytes = rec.counters.get("peer_bytes")
    if rec.trace is None or not nbytes:
        return None
    s, n = rec.trace.device_s(COPIES)
    return nbytes / 1e9 / s if n and s > 0 else None
