"""Date / timestamp support: epoch-integer storage, device civil math.

Counterpart of ``radix_sort_tpu/dates.py``. Storage follows the Arrow
columnar convention, no wrapper types on the device:

  - DATE       = ``int32`` days since 1970-01-01 (Arrow ``date32``)
  - TIMESTAMP  = ``int64`` microseconds since the epoch (Arrow
    ``timestamp[us]``; always available here, where the JAX package needs
    ``jax_enable_x64``)

so every engine operator (sort, group-by, join, min/max, windows,
comparisons) runs on dates as plain integers at full speed, and only
the calendar functions below do real work. Those are vectorized
translations of Howard Hinnant's branchless civil-calendar algorithms
(https://howardhinnant.github.io/date_algorithms.html, public domain):
pure integer adds/multiplies/floor-divides on int32 / int64 tensors, no
lookup tables, no data-dependent control flow.

``Table`` auto-converts ``numpy.datetime64`` input columns
(day-or-coarser units -> date32 days; finer -> int64 microseconds) and
``decode_days``/``decode_us`` convert back for display.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "US_PER_DAY",
    "is_datetime_data",
    "encode_datetime64",
    "decode_days",
    "decode_us",
    "parse_date",
    "parse_timestamp",
    "civil_from_days",
    "days_from_civil",
    "year",
    "month",
    "day",
    "day_of_week",
    "day_of_year",
    "week",
    "quarter",
    "trunc_days",
    "add_months",
    "DATE_NUM_FNS",
    "EXTRACT_FIELDS",
    "TRUNC_UNITS",
]

US_PER_DAY = 86_400_000_000


def is_datetime_data(x) -> bool:
    """True for host-side datetime64 data (numpy array or a list of
    ``np.datetime64`` scalars)."""
    if isinstance(x, np.ndarray):
        return x.dtype.kind == "M"
    if isinstance(x, (list, tuple)):
        return (len(x) > 0
                and all(isinstance(v, np.datetime64) for v in x))
    return False


def encode_datetime64(x):
    """Host datetime64 data -> ``(values, unit)`` where unit is
    ``"day"`` (int32 epoch days, for day-or-coarser input) or ``"us"``
    (int64 epoch microseconds)."""
    arr = np.asarray(x)
    unit = np.datetime_data(arr.dtype)[0]
    if unit in ("Y", "M", "W", "D"):
        return arr.astype("datetime64[D]").astype(np.int64).astype(
            np.int32), "day"
    return arr.astype("datetime64[us]").astype(np.int64), "us"


def decode_days(days) -> np.ndarray:
    """int32 epoch days -> ``datetime64[D]`` (host)."""
    return np.asarray(days).astype(np.int64).astype("datetime64[D]")


def decode_us(us) -> np.ndarray:
    """int64 epoch microseconds -> ``datetime64[us]`` (host)."""
    return np.asarray(us).astype(np.int64).astype("datetime64[us]")


def parse_date(s: str) -> int:
    """``'2026-08-20'`` -> epoch days (int). Raises ValueError on junk
    (numpy's ISO parser)."""
    return int(np.datetime64(s, "D").astype(np.int64))


def parse_timestamp(s: str) -> int:
    """``'2026-08-20 12:34:56[.ffffff]'`` -> epoch microseconds."""
    return int(np.datetime64(s.strip().replace(" ", "T"), "us")
               .astype(np.int64))


# ---------------------------------------------------------------------------
# device civil math (Hinnant's algorithms, vectorized int32)
# ---------------------------------------------------------------------------


def _i32(x):
    """``x`` (tensor, array or Python int) as an int32 tensor."""
    return x.to(torch.int32) if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.int32)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z):
    """Epoch days -> ``(year, month, day)`` int32 tensors."""
    z = _i32(z) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11], Mar=0
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return (y + (m <= 2)).to(torch.int32), m.to(torch.int32), \
        d.to(torch.int32)


def days_from_civil(y, m, d):
    """``(year, month, day)`` -> epoch days (int32). Inverse of
    :func:`civil_from_days` for valid civil dates."""
    y = _i32(y) - (_i32(m) <= 2).to(torch.int32)
    m = _i32(m)
    d = _i32(d)
    era = _fdiv(y, 400)
    yoe = y - era * 400  # [0, 399]
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def year(z):
    return civil_from_days(z)[0]


def month(z):
    return civil_from_days(z)[1]


def day(z):
    return civil_from_days(z)[2]


def day_of_week(z):
    """ISO day of week: 1 = Monday ... 7 = Sunday (1970-01-01 was a
    Thursday)."""
    z = _i32(z)
    return (z + 3) - _fdiv(z + 3, 7) * 7 + 1


def day_of_year(z):
    y, _, _ = civil_from_days(z)
    return _i32(z) - days_from_civil(y, 1, 1) + 1


def week(z):
    """ISO-8601 week number (the week containing the year's first
    Thursday is week 1)."""
    z = _i32(z)
    # Thursday of z's ISO week determines the ISO year
    thu = z - (day_of_week(z) - 4)
    y, _, _ = civil_from_days(thu)
    jan1 = days_from_civil(y, 1, 1)
    return (thu - jan1) // 7 + 1


def quarter(z):
    return (civil_from_days(z)[1] - 1) // 3 + 1


def trunc_days(unit: str, z):
    """Truncate epoch days to the start of ``unit`` in
    ``{"year", "quarter", "month", "week", "day"}`` (week = ISO Monday);
    returns epoch days."""
    z = _i32(z)
    if unit == "day":
        return z
    if unit == "week":
        return z - (day_of_week(z) - 1)
    y, m, _ = civil_from_days(z)
    if unit == "month":
        return days_from_civil(y, m, 1)
    if unit == "quarter":
        return days_from_civil(y, ((m - 1) // 3) * 3 + 1, 1)
    if unit == "year":
        return days_from_civil(y, 1, 1)
    raise ValueError(
        f"unknown DATE_TRUNC unit {unit!r} (supported: year, quarter, "
        f"month, week, day)"
    )


def _days_in_month(y, m):
    nxt = days_from_civil(y + (m == 12), torch.where(m == 12, 1, m + 1), 1)
    return nxt - days_from_civil(y, m, 1)


def add_months(z, n: int):
    """Epoch days + ``n`` calendar months, day-of-month clamped to the
    target month's length (SQL INTERVAL MONTH semantics:
    Jan 31 + 1 month = Feb 28/29)."""
    y, m, d = civil_from_days(z)
    t = y * 12 + (m - 1) + int(n)
    ty = _fdiv(t, 12)
    tm = t - ty * 12 + 1
    td = torch.minimum(d, _days_in_month(ty, tm).to(torch.int32))
    return days_from_civil(ty, tm, td)


# ---------------------------------------------------------------------------
# timestamp (int64 epoch microseconds) helpers
# ---------------------------------------------------------------------------

US_PER_SECOND = 1_000_000
US_PER_MINUTE = 60 * US_PER_SECOND
US_PER_HOUR = 3600 * US_PER_SECOND


def ts_days(ts):
    """Epoch microseconds -> epoch days (int32), floored (correct for
    pre-1970 values)."""
    return _fdiv(torch.as_tensor(ts), US_PER_DAY).to(torch.int32)


def _ts_field(ts, unit_us, modulus):
    ts = torch.as_tensor(ts)
    return (_fdiv(ts, unit_us)
            - _fdiv(ts, unit_us * modulus) * modulus
            ).to(torch.int32)


def ts_hour(ts):
    return _ts_field(ts, US_PER_HOUR, 24)


def ts_minute(ts):
    return _ts_field(ts, US_PER_MINUTE, 60)


def ts_second(ts):
    return _ts_field(ts, US_PER_SECOND, 60)


def ts_millisecond(ts):
    return _ts_field(ts, 1_000, 1_000)


def ts_microsecond(ts):
    return _ts_field(ts, 1, 1_000_000)


def ts_epoch_seconds(ts):
    """EXTRACT(EPOCH): whole seconds since 1970 (int64, floored)."""
    return _fdiv(torch.as_tensor(ts), US_PER_SECOND)


def trunc_us(unit: str, ts):
    """Truncate epoch microseconds to the start of ``unit`` in
    ``{"year", "quarter", "month", "week", "day", "hour", "minute",
    "second"}``; returns epoch microseconds."""
    ts = torch.as_tensor(ts)
    fixed = {"day": US_PER_DAY, "hour": US_PER_HOUR,
             "minute": US_PER_MINUTE, "second": US_PER_SECOND}
    if unit in fixed:
        u = fixed[unit]
        return _fdiv(ts, u) * u
    days = trunc_days(unit, ts_days(ts))  # validates the unit
    return days.to(torch.int64) * US_PER_DAY


# name -> device fn over an epoch-days int array (the SQL surface)
DATE_NUM_FNS = {
    "year": year,
    "month": month,
    "day": day,
    "dow": day_of_week,
    "doy": day_of_year,
    "week": week,
    "quarter": quarter,
}

# name -> device fn over an int64 epoch-microseconds array (timestamp
# fields; date fields apply to timestamps via ts_days)
TS_NUM_FNS = {
    "hour": ts_hour,
    "minute": ts_minute,
    "second": ts_second,
    "ms": ts_millisecond,
    "us": ts_microsecond,
    "epoch": ts_epoch_seconds,
}

EXTRACT_FIELDS = {
    "YEAR": "year", "MONTH": "month", "DAY": "day",
    "DOW": "dow", "DAYOFWEEK": "dow", "ISODOW": "dow",
    "DOY": "doy", "DAYOFYEAR": "doy",
    "WEEK": "week", "QUARTER": "quarter",
    "HOUR": "hour", "MINUTE": "minute", "SECOND": "second",
    "MILLISECOND": "ms", "MILLISECONDS": "ms",
    "MICROSECOND": "us", "MICROSECONDS": "us", "EPOCH": "epoch",
}

TRUNC_UNITS = ("year", "quarter", "month", "week", "day",
               "hour", "minute", "second")
