"""Unit tests for the trace summarizer (volym/bench/trace.py): build tiny
XSpace protobufs by hand and parse them."""

import numpy as np
import pytest

from volym.bench import trace


def _tag(fnum, wt):
    return bytes([(fnum << 3) | wt])


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _ld(fnum, payload):
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _vi(fnum, v):
    return _tag(fnum, 0) + _varint(v)


def _meta(mid, name):
    # map<int64, XEventMetadata> entry {key=1, value=2}; XEventMetadata
    # {id=1: varint, name=2: string}
    return _ld(4, _vi(1, mid) + _ld(2, _vi(1, mid) + _ld(2, name)))


def _event(mid, offset_ps, dur_ps):
    # XEvent {metadata_id=1, offset_ps=2, duration_ps=3}
    return _ld(4, _vi(1, mid) + _vi(2, offset_ps) + _vi(3, dur_ps))


def _line(name, ts_ns, events):
    # XLine {name=2, timestamp_ns=3, events=4}
    return _ld(3, _ld(2, name) + _vi(3, ts_ns) + b"".join(events))


def _write(tmp_path, planes):
    space = b"".join(_ld(1, p) for p in planes)
    p = tmp_path / "x" / "test.xplane.pb"
    p.parent.mkdir(exist_ok=True)
    p.write_bytes(space)
    return p


def test_trace_parser_roundtrip(tmp_path):
    # XEvent {metadata_id=1, duration_ps=3}: 2.5 ms = 2.5e9 ps
    ev = _ld(4, _vi(1, 7) + _vi(3, 2_500_000_000))
    line = _ld(3, _ld(2, b"step") + ev + ev)
    plane = _ld(2, b"/device:GPU:0") + line + _meta(7, b"matmul.1")
    p = _write(tmp_path, [plane])

    planes = trace.parse_xspace(str(p))
    assert len(planes) == 1
    assert planes[0].name == "/device:GPU:0"
    (name, t, c), = planes[0].top()
    assert name == "matmul.1" and c == 2
    np.testing.assert_allclose(t, 5e-3, rtol=1e-9)

    table = trace.device_op_table(str(tmp_path))
    assert "matmul.1" in table and "/device:GPU:0" in table


@pytest.mark.parametrize(
    "name, is_device",
    [
        ("/device:GPU:0", True),
        ("/device:GPU:3", True),
        ("/device:CPU:0", False),
        ("/host:CPU", False),
        ("/host:metadata", False),
        ("Task Environment", False),
    ],
)
def test_is_device_plane(name, is_device):
    assert trace.is_device_plane(name) is is_device


def test_busy_and_idle_share_union_of_streams(tmp_path):
    """Busy time is the union of kernel intervals across stream lines."""
    ms = 1_000_000_000  # ps
    s1 = _line(b"Stream #1(Compute)", 1_000, [_event(1, 0, 2 * ms), _event(1, 6 * ms, 2 * ms)])
    # overlaps the first kernel of stream 1 by 1 ms
    s2 = _line(b"Stream #2(Compute)", 1_000, [_event(2, 1 * ms, 2 * ms)])
    plane = (
        _ld(2, b"/device:GPU:0") + s1 + s2
        + _meta(1, b"fusion.1") + _meta(2, b"gather.2")
    )
    p = _write(tmp_path, [plane])
    (pl,) = trace.parse_xspace(str(p))
    window, busy, idle = pl.busy()
    np.testing.assert_allclose(window, 8e-3, rtol=1e-12)
    np.testing.assert_allclose(busy, 5e-3, rtol=1e-12)  # [0,3] + [6,8]
    np.testing.assert_allclose(idle, 3 / 8, rtol=1e-12)
    assert pl.ops["fusion.1"] == (pytest.approx(4e-3), 2)


def test_busy_of_empty_plane_is_zero():
    assert trace.PlaneSummary(name="/device:GPU:0").busy() == (0.0, 0.0, 0.0)


def test_line_timestamps_offset_events(tmp_path):
    """Events of two lines are placed by each line's own timestamp_ns."""
    ms = 1_000_000_000
    a = _line(b"Stream #1", 0, [_event(1, 0, 1 * ms)])
    b = _line(b"Stream #2", 3_000_000, [_event(1, 0, 1 * ms)])  # starts at 3 ms
    p = _write(tmp_path, [_ld(2, b"/device:GPU:0") + a + b + _meta(1, b"k")])
    (pl,) = trace.parse_xspace(str(p))
    window, busy, idle = pl.busy()
    np.testing.assert_allclose((window, busy, idle), (4e-3, 2e-3, 0.5), rtol=1e-12)


def test_device_op_table_skips_host_planes(tmp_path):
    host = _ld(2, b"/host:CPU") + _line(b"t", 0, [_event(1, 0, 5)]) + _meta(1, b"hostop")
    cpu = _ld(2, b"/device:CPU:0") + _line(b"t", 0, [_event(1, 0, 5)]) + _meta(1, b"cpuop")
    _write(tmp_path, [host, cpu])
    table = trace.device_op_table(str(tmp_path))
    assert "no device plane" in table
    assert "hostop" not in table and "cpuop" not in table


def test_truncated_trace_raises(tmp_path):
    p = tmp_path / "bad.xplane.pb"
    p.write_bytes(_ld(1, _ld(2, b"/device:GPU:0"))[:-3])
    with pytest.raises(ValueError, match="truncated"):
        trace.parse_xspace(str(p))


def test_recorded_h100_trace(tmp_path):
    """The device plane of a real trace: three 1024x768 Base forward frames
    of the slab march on an H100 (``chip_smoke.py --trace``), host planes
    stripped.  Stream lines only, no module events: busy time is the
    union of the kernels."""
    import gzip
    from pathlib import Path

    src = Path(__file__).parent / "fixtures" / "h100_slab_base_1024x768.xplane.pb.gz"
    (tmp_path / "t").mkdir()
    (tmp_path / "t" / "h100.xplane.pb").write_bytes(gzip.decompress(src.read_bytes()))
    (pl,) = trace.parse_xspace(str(tmp_path / "t" / "h100.xplane.pb"))
    assert pl.name == "/device:GPU:0" and trace.is_device_plane(pl.name)
    assert set(pl.lines) == {"Stream #13(Compute)", "Stream #14(MemcpyH2D)"}
    window, busy, idle = pl.busy()
    np.testing.assert_allclose((window, busy), (12.246e-3, 10.999e-3), rtol=1e-3)
    assert 0.09 < idle < 0.11
    (top, t, count), *_ = pl.top()
    assert top == "loop_add_clamp_select_fusion" and count == 192  # 64 planes x 3 frames
    assert "idle share 0.10" in trace.device_op_table(str(tmp_path / "t"))
