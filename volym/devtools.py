"""Offline asset prep: 3D Slicer ``.seg.nrrd`` -> (segments.json, segments.raw).

Port of ``volym_devtools`` (``volym_devtools/src/main.rs:15-95``): regex over
the NRRD header for ``Segment<i>_{Name,ID,LabelValue}`` keys, importance
defaulting to 0 (hand-edited afterwards, per ``volym_devtools/README.md``),
and the raw payload split off to a separate file (native C++ fast path in
:mod:`volym.native`, Python fallback here).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

_NAME = re.compile(r"Segment(\d+)_Name:=(.*)")
_ID = re.compile(r"Segment(\d+)_ID:=(.*)")
_LABEL = re.compile(r"Segment(\d+)_LabelValue:=(.*)")


def parse_segments(nrrd_path) -> list[dict]:
    """Header scan -> segment dicts sorted by index, importance 0."""
    names: dict[int, str] = {}
    ids: dict[int, str] = {}
    labels: dict[int, int] = {}
    with open(nrrd_path, "rb") as f:
        for raw_line in f:
            if raw_line.strip() == b"":
                break  # header ends at the blank line
            try:
                line = raw_line.decode("utf-8", errors="ignore")
            except UnicodeDecodeError:
                continue
            if m := _NAME.match(line):
                names[int(m.group(1))] = m.group(2).strip()
            elif m := _ID.match(line):
                ids[int(m.group(1))] = m.group(2).strip()
            elif m := _LABEL.match(line):
                labels[int(m.group(1))] = int(m.group(2))
    return [
        {
            "index": i,
            "name": names[i],
            "id": ids.get(i, f"Segment_{i}"),
            "label_value": labels.get(i, 0),
            "importance": 0,
        }
        for i in sorted(names)
    ]


def split_payload(nrrd_path, raw_out) -> int:
    """Write the data payload (bytes after the header's blank line) to
    ``raw_out``; returns byte count."""
    from volym import native

    if native.available():
        return native.nrrd_raw_bytes(str(nrrd_path), str(raw_out))
    data = Path(nrrd_path).read_bytes()
    for sep in (b"\n\n", b"\r\n\r\n"):
        idx = data.find(sep)
        if idx >= 0:
            payload = data[idx + len(sep) :]
            break
    else:
        payload = b""
    Path(raw_out).write_bytes(payload)
    return len(payload)


def convert(nrrd_path, json_out, raw_out) -> None:
    """Full devtools conversion (``volym_devtools/src/main.rs:30-32``)."""
    segments = parse_segments(nrrd_path)
    Path(json_out).write_text(json.dumps(segments, indent=2, sort_keys=True))
    split_payload(nrrd_path, raw_out)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="NRRD -> segments.json + raw labels (volym_devtools port)"
    )
    ap.add_argument("input", help="input .seg.nrrd")
    ap.add_argument("json_out", help="output segments.json")
    ap.add_argument("raw_out", help="output raw label bytes")
    args = ap.parse_args(argv)
    convert(args.input, args.json_out, args.raw_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
