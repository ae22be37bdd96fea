"""Host milliseconds of ``sql(text, tables, **kw)`` (parse and plan), the
mean over the window's queries."""


def read(rec):
    return 1e3 * sum(rec.plan_s) / len(rec.plan_s) if rec.plan_s else None
