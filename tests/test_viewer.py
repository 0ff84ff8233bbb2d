"""Interactive viewer endpoint tests (no browser; the server is stateless
so /frame is directly drivable — see volym/viewer.py)."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

from volym import RenderParams, Scene
from volym import viewer

RES = 16
PARAMS = RenderParams(
    use_gaussian_smoothing=False,
    use_shading=False,
    raymarching_step_size=0.05,
    max_steps=60,
)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    scene = Scene.synthetic("sphere", side=16)
    shots = tmp_path_factory.mktemp("shots")
    srv = viewer.make_server(
        scene, PARAMS, RES, RES, port=0, screenshot_dir=str(shots)
    )
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, shots
    srv.shutdown()
    srv.server_close()


def _get(srv, path):
    host, port = srv.server_address
    return urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60)


def _png_shape(data: bytes):
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    return np.asarray(img).shape


def test_index_page(server):
    srv, _ = server
    with _get(srv, "/") as r:
        body = r.read().decode()
    assert r.status == 200
    assert "canvas" in body or "img" in body
    assert "__INIT__" not in body  # payload substituted
    assert '"width": 16' in body


def test_frame_endpoint_renders(server):
    srv, _ = server
    with _get(srv, "/frame?h=30&v=20&dist=1.2&renderer=ray") as r:
        data = r.read()
    assert r.status == 200
    assert data[:4] == b"\x89PNG"
    assert _png_shape(data) == (RES, RES, 4)
    assert float(r.headers["X-Render-Ms"]) > 0
    assert len(r.headers["X-Camera-Pos"].split(",")) == 3


@pytest.mark.parametrize("backend", ["slab"])
def test_frame_slab_backends(server, backend):
    srv, _ = server
    with _get(srv, f"/frame?h=10&v=5&dist=1.1&renderer={backend}") as r:
        data = r.read()
    assert data[:4] == b"\x89PNG"


def test_frame_live_knobs_change_image(server):
    srv, _ = server
    base = "/frame?h=30&v=20&dist=1.2&renderer=ray&threshold="
    with _get(srv, base + "0.05") as r:
        a = r.read()
    with _get(srv, base + "0.6") as r:
        b = r.read()
    assert a != b  # the knob reached the kernel


def test_mode_dependency_rules():
    # gui.rs: importance rendering forces opacity on; cone needs imp on
    p = viewer.params_from_query(
        {"use_importance_rendering": ["1"], "use_opacity": ["0"]}, PARAMS
    )
    assert p.use_opacity and p.use_importance_rendering
    p = viewer.params_from_query(
        {"use_cone_importance_check": ["1"]}, PARAMS
    )
    assert not p.use_cone_importance_check


def test_camera_clamps():
    cam = viewer.camera_from_query({"v": ["200"], "dist": ["99"]}, 1.0)
    assert cam.vertical_angle == 89.0
    assert cam.distance == 10.0


def test_screenshot_endpoint(server):
    srv, shots = server
    with _get(srv, "/screenshot?h=0&v=0&dist=1.2&renderer=ray") as r:
        meta = json.loads(r.read())
    assert (shots / meta["path"].split("/")[-1]).exists()


@pytest.mark.parametrize("backend", ["pallas", "nope"])
def test_frame_unknown_backend_400(server, backend):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, f"/frame?renderer={backend}")
    assert e.value.code == 400
    assert b"unknown renderer backend" in e.value.read()


def test_page_offers_only_live_backends(server):
    srv, _ = server
    with _get(srv, "/") as r:
        body = r.read().decode()
    assert 'value="ray"' in body and 'value="slab"' in body
    assert body.count("<option value=") == 2 and "fast_math" not in body


def test_unknown_path_404(server):
    srv, _ = server
    try:
        _get(srv, "/nope")
        assert False, "expected 404"
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_frame_live_resize(server):
    """Per-request render size (live resize, gpu_context.rs:68-75 analog):
    pw/ph override the launch resolution, clamped + rounded to /8."""
    srv, _ = server
    with _get(srv, "/frame?h=30&v=20&dist=1.2&renderer=ray&pw=32&ph=24") as r:
        data = r.read()
    assert r.status == 200
    assert _png_shape(data) == (24, 32, 4)
    # rounding + clamping: 70 -> 64; 9000 -> 2048
    with _get(srv, "/frame?h=30&v=20&dist=1.2&renderer=ray&pw=70&ph=70") as r:
        data = r.read()
    assert _png_shape(data) == (64, 64, 4)
