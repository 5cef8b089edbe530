"""Viewer smoke test: boot the render thread + HTTP server, drive the
JSON API like the browser UI does (state fetch, settings mutation with
accumulation reset, camera move, frame fetch), shut down cleanly.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest


@pytest.mark.slow
def test_viewer_api_roundtrip(tri_scene):
    from http.server import ThreadingHTTPServer

    from dustraytracer.apps.viewer import ViewerState, make_handler
    from dustraytracer.scene import make_camera
    from dustraytracer.scene.settings import RenderSettings

    cam = make_camera(position=(0, 2, 6), look_at=(0, 1, 0), vfov_deg=50)
    state = ViewerState(tri_scene, cam, RenderSettings(bounces=1),
                        width=64, height=48, speed=0.2)
    t = threading.Thread(target=state.run, daemon=True)
    t.start()

    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              make_handler(state, ["night"]))
    port = srv.server_address[1]
    st = threading.Thread(target=srv.serve_forever, daemon=True)
    st.start()

    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.read(), r.headers.get_content_type()

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()

    try:
        # wait for at least one accumulated sample
        for _ in range(100):
            body, _ = get("/state")
            s = json.loads(body)
            if s["samples"] >= 1:
                break
            time.sleep(0.3)
        assert s["samples"] >= 1
        assert s["scene"]["triangles"] > 0
        assert s["settings"]["smooth_shading"] is False
        assert s["settings"]["tex_filter"] == "point"

        png, ctype = get("/frame.png")
        assert ctype == "image/png" and png[:4] == b"\x89PNG"

        # settings mutation resets accumulation and takes effect
        post("/api", {"set": {"smooth_shading": True, "bounces": 2}})
        time.sleep(0.5)
        body, _ = get("/state")
        s2 = json.loads(body)
        assert s2["settings"]["smooth_shading"] is True
        assert s2["settings"]["bounces"] == 2

        # resize-reactive render target (Renderer::ResizeBuffer parity)
        post("/api", {"resize": [48, 32]})
        for _ in range(100):
            body, _ = get("/state")
            s3 = json.loads(body)
            if s3["size"] == [48, 32] and s3["samples"] >= 1:
                break
            time.sleep(0.3)
        assert s3["size"] == [48, 32]
        import io
        png, _ = get("/frame.png")
        # PNG IHDR carries width/height big-endian at bytes 16..24
        import struct
        w_px, h_px = struct.unpack(">II", png[16:24])
        assert (w_px, h_px) == (48, 32)

        # camera-parameter mutation (EditorLayer.cpp:265-268 parity):
        # vfov/focus/defocus/exposure apply with an accumulation reset
        post("/api", {"camera": {"vfov_deg": 35.0, "focus_dist": 4.5,
                                 "defocus_angle": 2.0, "exposure": 1.5,
                                 "position": [9, 9, 9]}})  # ignored key
        post("/api", {"speed": 0.33})
        time.sleep(0.5)
        body, _ = get("/state")
        s4 = json.loads(body)
        assert s4["camera"]["vfov_deg"] == pytest.approx(35.0)
        assert s4["camera"]["focus_dist"] == pytest.approx(4.5)
        assert s4["camera"]["defocus_angle"] == pytest.approx(2.0)
        assert s4["camera"]["exposure"] == pytest.approx(1.5)
        assert s4["camera"]["speed"] == pytest.approx(0.33)
        # position is NOT settable through the camera dict (fly controls
        # own it) — the bogus key must be dropped, not crash
        assert s4["camera"]["position"] != [9, 9, 9]
        # ... and the accumulation restarted after the change
        for _ in range(100):
            body, _ = get("/state")
            s5 = json.loads(body)
            if s5["samples"] >= 1:
                break
            time.sleep(0.3)
        assert s5["samples"] >= 1

        # index page serves the UI
        idx, ctype = get("/")
        assert b"dustraytracer" in idx.lower() or b"viewport" in idx.lower()
    finally:
        state.running = False
        srv.shutdown()
