"""Minimal XPlane (``jax.profiler`` trace) reader — no protobuf dependency.

``jax.profiler.start_trace`` writes ``plugins/profile/<run>/*.xplane.pb``,
a serialized ``tensorflow.profiler.XSpace``.  This module hand-parses the
protobuf wire format against the (public, stable) XSpace schema — enough
to reconstruct the device timeline: planes → lines → events with
picosecond offsets/durations and resolved metadata names.  That powers
:func:`cgx.utils.profiling.trace_report` (per-op totals).

Wire-format background: each field is a (tag, value) pair; tag =
(field_number << 3) | wire_type; wire types used by XSpace are 0 (varint)
and 2 (length-delimited).  Schema (from tsl/profiler/protobuf/xplane.proto):

    XSpace:    1: repeated XPlane planes
    XPlane:    1: id, 2: name, 3: repeated XLine lines,
               4: map<int64, XEventMetadata> event_metadata,
               5: map<int64, XStatMetadata> stat_metadata
    XLine:     1: id, 2: name, 3: timestamp_ns, 4: repeated XEvent events,
               11: display_name
    XEvent:    1: metadata_id, 2: offset_ps, 3: duration_ps
    XEventMetadata: 1: id, 2: name, 9: display_name
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["XEvent", "XLine", "XPlane", "parse_xspace", "load_xspace",
           "find_xplane_files"]


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message body."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:                       # varint
            val, i = _varint(buf, i)
        elif wtype == 2:                     # length-delimited
            ln, i = _varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wtype == 5:                     # 32-bit
            val = buf[i:i + 4]
            i += 4
        elif wtype == 1:                     # 64-bit
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _signed(v: int) -> int:
    """Interpret a varint as int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class XEvent:
    metadata_id: int = 0
    offset_ps: int = 0
    duration_ps: int = 0
    name: str = ""                           # resolved from plane metadata

    @property
    def end_ps(self) -> int:
        return self.offset_ps + self.duration_ps


@dataclass
class XLine:
    id: int = 0
    name: str = ""
    display_name: str = ""
    timestamp_ns: int = 0
    events: List[XEvent] = field(default_factory=list)

    @property
    def label(self) -> str:
        return self.display_name or self.name


@dataclass
class XPlane:
    id: int = 0
    name: str = ""
    lines: List[XLine] = field(default_factory=list)
    event_names: Dict[int, str] = field(default_factory=dict)


def _parse_event(buf: bytes) -> XEvent:
    e = XEvent()
    for f, w, v in _fields(buf):
        if f == 1:
            e.metadata_id = _signed(v)
        elif f == 2:
            e.offset_ps = _signed(v)
        elif f == 3:
            e.duration_ps = _signed(v)
    return e


def _parse_line(buf: bytes) -> XLine:
    ln = XLine()
    for f, w, v in _fields(buf):
        if f == 1:
            ln.id = _signed(v)
        elif f == 2:
            ln.name = v.decode("utf-8", "replace")
        elif f == 3:
            ln.timestamp_ns = _signed(v)
        elif f == 4:
            ln.events.append(_parse_event(v))
        elif f == 11:
            ln.display_name = v.decode("utf-8", "replace")
    return ln


def _parse_event_metadata(buf: bytes) -> Tuple[int, str]:
    mid, name, display = 0, "", ""
    for f, w, v in _fields(buf):
        if f == 1:
            mid = _signed(v)
        elif f == 2:
            name = v.decode("utf-8", "replace")
        elif f == 9:
            display = v.decode("utf-8", "replace")
    return mid, display or name


def _parse_metadata_entry(buf: bytes) -> Tuple[int, str]:
    """map<int64, XEventMetadata> entry: 1: key, 2: value."""
    key, name = 0, ""
    for f, w, v in _fields(buf):
        if f == 1:
            key = _signed(v)
        elif f == 2:
            mid, name = _parse_event_metadata(v)
            if mid:
                key = key or mid
    return key, name


def _parse_plane(buf: bytes) -> XPlane:
    p = XPlane()
    for f, w, v in _fields(buf):
        if f == 1:
            p.id = _signed(v)
        elif f == 2:
            p.name = v.decode("utf-8", "replace")
        elif f == 3:
            p.lines.append(_parse_line(v))
        elif f == 4:
            k, name = _parse_metadata_entry(v)
            p.event_names[k] = name
    for ln in p.lines:
        for e in ln.events:
            e.name = p.event_names.get(e.metadata_id, f"#{e.metadata_id}")
    return p


def parse_xspace(data: bytes) -> List[XPlane]:
    """Parse a serialized XSpace into planes with resolved event names."""
    planes = []
    for f, w, v in _fields(data):
        if f == 1:
            planes.append(_parse_plane(v))
    return planes


def find_xplane_files(log_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))


def load_xspace(log_dir: str) -> List[XPlane]:
    """All planes from the newest profile run under ``log_dir``."""
    files = find_xplane_files(log_dir)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir!r}")
    planes: List[XPlane] = []
    for path in files:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            planes.extend(parse_xspace(f.read()))
    return planes
