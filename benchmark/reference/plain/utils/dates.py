"""Date/time utilities.

Model time is measured in decimal days since 1900-01-01 00:00 UTC, matching
the reference convention (reference: core/include/date.hpp:61) so restart
files, forcing windows and output filenames are directly comparable.

These run on the host (Python) only — model time never enters a jit trace as
a traced value; the per-step `dt` and absolute time are passed as static or
scalar operands.
"""

from __future__ import annotations

import datetime as _dt

EPOCH = _dt.datetime(1900, 1, 1)
DAYS_IN_SEC = 1.0 / 86400.0
SECONDS_PER_DAY = 86400.0


def string_to_datenum(s: str) -> float:
    """Parse a date string to decimal days since 1900-01-01.

    Accepts ``YYYY-MM-DD``, ``YYYY-MM-DD HH:MM:SS``, ``YYYY-Mon-DD`` and
    compact ``YYYYMMDD`` forms (the formats accepted by the reference's
    stringToDatenum, core/include/date.hpp).
    """
    s = s.strip()
    fmts = (
        "%Y-%m-%d %H:%M:%S",
        "%Y-%m-%d",
        "%Y-%b-%d",
        "%Y%m%d",
        "%Y-%m-%dT%H:%M:%SZ",
        "%Y%m%dT%H%M%SZ",
    )
    for fmt in fmts:
        try:
            d = _dt.datetime.strptime(s, fmt)
            return datetime_to_datenum(d)
        except ValueError:
            continue
    raise ValueError(f"unrecognised date string: {s!r}")


def datetime_to_datenum(d: _dt.datetime) -> float:
    delta = d - EPOCH
    return delta.days + delta.seconds / SECONDS_PER_DAY + delta.microseconds / (SECONDS_PER_DAY * 1e6)


def datenum_to_datetime(t: float) -> _dt.datetime:
    return EPOCH + _dt.timedelta(days=float(t))


def datenum_to_string(t: float, fmt: str = "%Y%m%dT%H%M%SZ") -> str:
    """Format a datenum, default matching the reference's output filenames."""
    return datenum_to_datetime(t).strftime(fmt)
