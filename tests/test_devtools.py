"""NRRD devtools port tests (reference volym_devtools/src/main.rs)."""

import json

import numpy as np

from volym import devtools

HEADER = b"""NRRD0004
# Complete NRRD file format specification at:
type: unsigned char
dimension: 3
sizes: 4 4 4
Segment0_Color:=0.5 0.6 0.7
Segment0_ID:=Segment_2
Segment0_LabelValue:=2
Segment0_Name:=Lobster
Segment1_ID:=Segment_4
Segment1_LabelValue:=3
Segment1_Name:=Cup
encoding: raw

"""


def _write_nrrd(tmp_path):
    payload = bytes(range(64))
    p = tmp_path / "test.seg.nrrd"
    p.write_bytes(HEADER + payload)
    return p, payload


def test_parse_segments(tmp_path):
    p, _ = _write_nrrd(tmp_path)
    segs = devtools.parse_segments(p)
    assert len(segs) == 2
    lob = next(s for s in segs if s["name"] == "Lobster")
    assert lob["label_value"] == 2
    assert lob["id"] == "Segment_2"
    assert lob["importance"] == 0  # defaults to 0, hand-edited after
    cup = next(s for s in segs if s["name"] == "Cup")
    assert cup["label_value"] == 3


def test_split_payload(tmp_path):
    p, payload = _write_nrrd(tmp_path)
    out = tmp_path / "seg.raw"
    n = devtools.split_payload(p, out)
    assert n == len(payload)
    assert out.read_bytes() == payload


def test_split_payload_python_fallback(tmp_path, monkeypatch):
    import volym.native as native

    monkeypatch.setattr(native, "available", lambda: False)
    p, payload = _write_nrrd(tmp_path)
    out = tmp_path / "seg2.raw"
    n = devtools.split_payload(p, out)
    assert n == len(payload)
    assert out.read_bytes() == payload


def test_convert_end_to_end(tmp_path):
    p, payload = _write_nrrd(tmp_path)
    jout = tmp_path / "segments.json"
    rout = tmp_path / "segments.raw"
    devtools.convert(p, jout, rout)
    segs = json.loads(jout.read_text())
    assert {s["name"] for s in segs} == {"Lobster", "Cup"}
    assert rout.read_bytes() == payload
