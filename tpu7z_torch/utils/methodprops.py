"""Method-property string parsing, a copy of tpu7z/utils/methodprops.py:
the MethodProps analog.

Behavioral reference: CPP/7zip/Common/MethodProps.cpp —
`-m0=zstd:x22:wlog=27:long`-style method specs (ParseMethodFromString,
MethodProps.h:339), dictionary/size strings where a bare number is a
log2 size and b/k/m/g suffixes are byte units (StringToDictSize,
MethodProps.cpp:763+), and the extended `-mmt` thread grammar
(ParseMtProp, MethodProps.cpp:113-192): on/off/N, dN force-down,
uN/+N force-up, pN percent, and combinations like `p25u1` / `p1+1`.
"""

from __future__ import annotations

from .errors import TpuzError

_UNITS = {"b": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def parse_size(s: str) -> int:
    """Dictionary/size string: bare number = log2 (``24`` -> 16 MiB),
    number+unit = bytes (``64k``, ``16m``, ``1g``, ``123b``)."""
    s = s.strip().lower()
    if not s:
        raise TpuzError("empty size value")
    i = 0
    while i < len(s) and s[i].isdigit():
        i += 1
    if i == 0:
        raise TpuzError(f"bad size value {s!r}")
    num = int(s[:i])
    suffix = s[i:]
    if not suffix:
        if num >= 64:
            raise TpuzError(f"log size {num} out of range")
        return 1 << num
    if suffix in _UNITS:
        return num * _UNITS[suffix]
    raise TpuzError(f"bad size suffix {suffix!r}")


def _coerce(value: str):
    low = value.lower()
    if low in ("on", "+", ""):
        return True
    if low in ("off", "-"):
        return False
    try:
        return int(value)
    except ValueError:
        return value


def parse_method_spec(spec: str):
    """``zstd:x22:wlog=27:long`` -> ("zstd", {"x": 22, "wlog": 27,
    "long": True}). Bare ``xN``/``dN``/``aN``-style numeric shorthands
    (no ``=``) are split at the first digit, matching the reference's
    PROPID-by-prefix parse."""
    parts = spec.split(":")
    name = parts[0].lower()
    props: dict = {}
    for p in parts[1:]:
        if not p:
            continue
        if "=" in p:
            k, v = p.split("=", 1)
            props[k.lower()] = _coerce(v)
            continue
        i = 0
        while i < len(p) and not p[i].isdigit():
            i += 1
        if i == 0 or i == len(p):
            props[p.lower()] = True
        else:
            props[p[:i].lower()] = int(p[i:])
    return name, props


def parse_mt(spec, num_cpus: int = 8) -> int:
    """The extended -mmt grammar. Returns the worker count; 0 means
    forced single-threaded (the reference's ``-mmt=off`` semantics)."""
    if spec is None or spec is True:
        return num_cpus
    if spec is False:
        return 0
    if isinstance(spec, int):
        return min(spec, num_cpus)
    s = str(spec).strip().lower().lstrip("=")
    if s == "" or s == "on":
        return num_cpus
    if s == "off":
        return 0
    num_th = num_cpus
    i = 0
    n = len(s)
    while i < n:
        force_ud = 0
        is_percent = False
        c = s[i]
        if c == "-":
            if i + 1 == n:
                return 0
            force_ud = -1
            i += 1
            if i < n and s[i] == "p":
                is_percent = True
                i += 1
        elif c == "d":
            force_ud = -1
            i += 1
            if i < n and s[i] == "p":
                is_percent = True
                i += 1
        elif c == "+":
            if i + 1 == n:
                return num_cpus
            force_ud = +1
            i += 1
            if i < n and s[i] == "p":
                is_percent = True
                i += 1
        elif c == "u":
            force_ud = +1
            i += 1
            if i < n and s[i] == "p":
                is_percent = True
                i += 1
        elif c == "p":
            is_percent = True
            i += 1
        j = i
        while j < n and s[j].isdigit():
            j += 1
        if j == i:
            if not force_ud:
                raise TpuzError(f"bad -mmt value {spec!r}")
            v = 1
        else:
            v = int(s[i:j])
        if is_percent:
            v = num_cpus * v // 100
        if force_ud:
            num_th += force_ud * v
        else:
            num_th = v
        i = j
    if num_th <= 0:
        num_th = 1
    return min(num_th, num_cpus)
