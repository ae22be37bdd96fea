"""The stable 64-bit sort passes of the aggregates' key sorts per completed
query: the growth of the program's ``ops/query.AGG_KEY_PASSES`` over the
window (the driver's ``agg_key_passes`` counter). None where the program
has no such counter."""


def read(rec):
    passes = rec.counters.get("agg_key_passes")
    if passes is None or not rec.completed:
        return None
    return passes / rec.completed
