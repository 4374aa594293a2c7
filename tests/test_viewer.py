"""The live HTTP viewer (tools/view.py --serve) — the analogue of the
reference's Perf.WindowsForms windowed viewer. Serves an MJPEG orbit stream,
single frames, and render-time stats."""

import json
import os
import sys
import threading
import urllib.request

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))


def test_live_viewer_frame_and_stats():
    import sdfkit as sk
    import view

    viewer = view.LiveViewer(sk.sphere(1.0, color=(0.8, 0.3, 0.2)), 64, 48)
    server = view.serve(viewer, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        jpg = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame.jpg", timeout=60
        ).read()
        assert jpg[:3] == b"\xff\xd8\xff"  # JPEG magic
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=60
        ).read()
        assert b"/stream" in html
        stats = json.loads(
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=60
            ).read()
        )
        assert stats["frame"] >= 1 and stats["render_ms"] > 0
    finally:
        server.shutdown()
