"""Summarize a ``jax.profiler`` trace into per-op on-device durations.

The trace directory written by ``jax.profiler.trace`` contains an XSpace
protobuf (``*.xplane.pb``).  No xplane proto bindings ship in this image
(tensorboard-plugin-profile predates the xprof split), so this module
decodes the stable public wire format directly — only the fields needed
for a per-op duration table:

    XSpace.planes[].lines[] {name, timestamp_ns}
    XLine.events[] {metadata_id, offset_ps, duration_ps}
    XPlane.event_metadata {id -> name}

Device planes are named ``/device:GPU:<n>`` (:func:`is_device_plane`); the
host's own planes (``/host:CPU``, ``/device:CPU:0`` for the XLA CPU
client) are skipped.  Per plane this keeps the summed duration of each op
and each line's event intervals, from which :meth:`PlaneSummary.busy`
gives the device's busy time and idle share over the traced window.

Reference-parity note: the reference has no GPU timestamps at all
(``timestamp_writes: None``, ``src/demos/pipeline.rs:73``); this is the
upgrade of its tracing story (SURVEY.md §5): ``--profile`` captures a
trace and this table attributes the frame to kernels.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    n = len(buf)
    while True:
        if i >= n:
            raise ValueError("truncated xplane.pb (varint past end of buffer)")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _varint(buf, i)
        elif wt == 1:  # 64-bit
            end = i + 8
        elif wt == 2:  # length-delimited
            ln, i = _varint(buf, i)
            end = i + ln
        elif wt == 5:  # 32-bit
            end = i + 4
        else:  # groups (3, 4) never appear in xplane
            raise ValueError(f"unsupported wire type {wt}")
        if wt != 0:
            if end > n:
                raise ValueError(
                    "truncated xplane.pb (field payload past end of buffer)"
                )
            val = buf[i:end]
            i = end
        yield fnum, wt, val


def is_device_plane(name: str) -> bool:
    """True for an accelerator's plane (``/device:GPU:0``), False for the
    host's planes, including the XLA CPU client's ``/device:CPU:0``."""
    n = name.lower()
    return n.startswith("/device:") and not n.startswith("/device:cpu")


@dataclass
class PlaneSummary:
    name: str
    #: op name -> (total_seconds, occurrences)
    ops: dict[str, tuple[float, int]] = field(default_factory=dict)
    #: line name -> [(start_ps, end_ps)] of its events
    lines: dict[str, list[tuple[int, int]]] = field(default_factory=dict)

    def busy(self) -> tuple[float, float, float]:
        """(window_s, busy_s, idle_share): busy is the union of the event
        intervals of every line (on a GPU plane, one line per CUDA stream,
        one event per kernel or copy); the window runs from the first
        event's start to the last one's end."""
        ivs = sorted(iv for evs in self.lines.values() for iv in evs)
        if not ivs:
            return 0.0, 0.0, 0.0
        busy_ps, cur_s, cur_e = 0, ivs[0][0], ivs[0][1]
        for a, b in ivs[1:]:
            if a > cur_e:
                busy_ps += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy_ps += cur_e - cur_s
        window_ps = max(b for _, b in ivs) - ivs[0][0]
        idle = 1.0 - busy_ps / window_ps if window_ps > 0 else 0.0
        return window_ps * 1e-12, busy_ps * 1e-12, idle

    def total_s(self) -> float:
        return sum(t for t, _ in self.ops.values())

    def top(self, n: int = 20) -> list[tuple[str, float, int]]:
        rows = sorted(
            ((name, t, c) for name, (t, c) in self.ops.items()),
            key=lambda r: -r[1],
        )
        return rows[:n]


def _parse_plane(buf: bytes) -> PlaneSummary:
    name = ""
    meta: dict[int, str] = {}
    lines: list[bytes] = []
    for fnum, wt, val in _fields(buf):
        if fnum == 2 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif fnum == 3 and wt == 2:
            lines.append(val)
        elif fnum == 4 and wt == 2:
            # map<int64, XEventMetadata> entry: {key=1, value=2}
            mid = None
            mname = None
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 0:
                    mid = v2
                elif f2 == 2 and w2 == 2:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 2 and w3 == 2:
                            mname = v3.decode("utf-8", "replace")
            if mid is not None and mname is not None:
                meta[mid] = mname
    plane = PlaneSummary(name=name)
    for line in lines:
        lname, ts_ns, events = "", 0, []
        for fnum, wt, val in _fields(line):
            if fnum == 2 and wt == 2:
                lname = val.decode("utf-8", "replace")
            elif fnum == 3 and wt == 0:
                ts_ns = val
            elif fnum == 4 and wt == 2:  # XEvent
                mid = off_ps = dur_ps = 0
                for f2, w2, v2 in _fields(val):
                    if f2 == 1 and w2 == 0:
                        mid = v2
                    elif f2 == 2 and w2 == 0:
                        off_ps = v2
                    elif f2 == 3 and w2 == 0:
                        dur_ps = v2
                opname = meta.get(mid, f"#{mid}")
                t, c = plane.ops.get(opname, (0.0, 0))
                plane.ops[opname] = (t + dur_ps * 1e-12, c + 1)
                events.append((off_ps, dur_ps))
        start = ts_ns * 1000
        plane.lines.setdefault(lname, []).extend(
            (start + o, start + o + d) for o, d in events
        )
    return plane


def parse_xspace(path: str) -> list[PlaneSummary]:
    """Parse one ``.xplane.pb`` file into per-plane op summaries."""
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for fnum, wt, val in _fields(buf):
        if fnum == 1 and wt == 2:
            planes.append(_parse_plane(val))
    return planes


def find_xplane(trace_dir: str) -> str:
    """Locate the newest ``*.xplane.pb`` under a trace directory."""
    hits = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not hits:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return hits[-1]


def device_op_table(trace_dir: str, top: int = 25) -> str:
    """Render a per-op duration table for the device plane(s) of a trace."""
    planes = parse_xspace(find_xplane(trace_dir))
    out = []
    for p in planes:
        if not p.ops:
            continue
        if not is_device_plane(p.name):
            continue
        window, busy, idle = p.busy()
        out.append(
            f"== {p.name}  (total {p.total_s()*1e3:.2f} ms across events; "
            f"window {window*1e3:.3f} ms, busy {busy*1e3:.3f} ms, "
            f"idle share {idle:.4f})"
        )
        for name, t, c in p.top(top):
            out.append(f"  {t*1e3:9.3f} ms  x{c:<5d} {name}")
    if not out:
        names = ", ".join(p.name for p in planes)
        out.append(f"no device plane with events found (planes: {names})")
    return "\n".join(out)


def main(argv: list[str]) -> int:
    import sys

    if not argv:
        print("usage: python -m volym.bench.trace <trace_dir> [top_n]")
        return 2
    top = int(argv[1]) if len(argv) > 1 else 25
    print(device_op_table(argv[0], top))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
