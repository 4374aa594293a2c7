"""Scene viewer CLI — the analogue of the reference's Perf.WindowsForms
interactive viewer (reference: Perf.WindowsForms/MainForm.cs), headless:
renders a scene to PNG (or TGA), optionally as an orbit turntable sequence.

Usage:
    python tools/view.py [--scene sphere_repeat] [--size 960x540]
                         [--out view.png] [--orbit N]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def scenes():
    import sdfkit as sk
    from bench import sphere_repeat_scene

    return {
        "sphere_repeat": sphere_repeat_scene,
        "sphere": lambda: sk.sphere(1.0, color=(0.9, 0.4, 0.2)),
        "csg": lambda: sk.sphere(1.0, color=(0.9, 0.3, 0.2)).smooth_union(
            sk.box(0.8, color=(0.2, 0.5, 0.9)).translate(1.0, 0, 0), 0.3
        ),
        "torus": lambda: sk.torus(1.0, 0.35, color=(0.4, 0.8, 0.5)).rotate_x(0.7),
    }


def save(path, img: np.ndarray) -> None:
    if path.endswith(".tga"):
        from sdfkit.io.tga import write_tga

        write_tga(path, img)
        return
    from PIL import Image

    rgb = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(rgb).save(path)


class LiveViewer:
    """Live in-browser viewer — the analogue of the reference's windowed
    Perf.WindowsForms viewer (MainForm.cs:17-84: background-task render,
    blit to the window, elapsed seconds in the title). Here the window is a
    browser tab: an MJPEG stream of a continuous camera orbit at `/stream`,
    a single `/frame.jpg`, and `/stats` (last render ms / effective Mrays/s,
    the title-text analogue, polled by the index page)."""

    # Streams are paced so a backgrounded tab doesn't keep the device
    # rendering at full rate; N viewers share one render loop via the lock.
    MAX_STREAM_FPS = 10.0

    def __init__(self, scene, width: int, height: int, distance: float = 5.0):
        import threading

        import sdfkit as sk

        self._sk = sk
        self.width, self.height, self.distance = width, height, distance
        self.marcher = sk.RayMarcher(width, height, scene)
        self.frame_index = 0
        self.last_render_ms = 0.0
        # ThreadingHTTPServer handles each connection on its own thread;
        # the lock serializes device renders and the stats they update.
        self._lock = threading.Lock()

    def render_frame(self) -> bytes:
        """Next orbit frame as JPEG bytes; updates the stats."""
        import io
        import time

        from PIL import Image

        sk = self._sk
        with self._lock:
            a = 0.03 * self.frame_index
            self.frame_index += 1
            view = sk.look_at(
                (self.distance * math.sin(a), 2.0,
                 self.distance * math.cos(a)),
                (0, 0, 0),
                (0, 1, 0),
            )
            t0 = time.perf_counter()
            img = np.asarray(self.marcher.render(camera=view))
            self.last_render_ms = (time.perf_counter() - t0) * 1e3
        rgb = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=85)
        return buf.getvalue()

    def stats(self) -> dict:
        ms = self.last_render_ms
        return {
            "frame": self.frame_index,
            "render_ms": round(ms, 2),
            "mrays_per_s": round(
                self.width * self.height / max(ms, 1e-9) / 1e3, 1
            ),
        }


_INDEX_HTML = """<!doctype html><title>sdfkit viewer</title>
<body style="margin:0;background:#111;color:#ddd;font:14px monospace">
<div id=t style="padding:6px">sdfkit</div>
<img src="/stream" style="max-width:100%">
<script>
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('t').textContent =
    `sdfkit - frame ${s.frame} - ${s.render_ms} ms (${s.mrays_per_s} Mrays/s)`;
  document.title = `${s.render_ms} ms`;
}, 500);
</script>"""


def serve(viewer: LiveViewer, port: int = 0):
    """Start the HTTP viewer; returns the (bound) server. Call
    ``serve_forever`` on it (the CLI does) or drive it from a thread."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/frame"):
                body = viewer.render_frame()
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/stats"):
                body = json.dumps(viewer.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                try:
                    import socket as _socket
                    import time as _time

                    # A client that stalls without closing (or a wedged
                    # connection) must not pin this thread rendering device
                    # frames forever: time out the socket writes, and honor
                    # the server's shutdown flag (ThreadingHTTPServer's
                    # shutdown() does not interrupt in-flight handlers).
                    self.connection.settimeout(10.0)
                    period = 1.0 / viewer.MAX_STREAM_FPS
                    while not getattr(self.server, "_sdfkit_down", False):
                        t0 = _time.perf_counter()
                        jpg = viewer.render_frame()
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                        )
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                        sleep = period - (_time.perf_counter() - t0)
                        if sleep > 0:
                            _time.sleep(sleep)
                except (BrokenPipeError, ConnectionResetError,
                        _socket.timeout, TimeoutError):
                    pass  # tab closed or stalled
            else:
                self.send_error(404)

    class _Server(ThreadingHTTPServer):
        def shutdown(self):
            # Signal in-flight /stream handler loops (base shutdown() only
            # stops accepting new connections).
            self._sdfkit_down = True
            super().shutdown()

    return _Server(("127.0.0.1", port), Handler)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sphere_repeat", choices=sorted(scenes()))
    ap.add_argument("--size", default="960x540")
    ap.add_argument("--out", default="sdfkit_view.png")
    ap.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="render N frames orbiting the origin (out gets -000 suffixes)")
    ap.add_argument("--distance", type=float, default=5.0)
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live orbiting MJPEG view at "
                         "http://127.0.0.1:PORT/ instead of writing files")
    args = ap.parse_args()

    import sdfkit as sk
    from sdfkit.utils.compile_cache import use_compile_cache

    use_compile_cache()

    w, h = (int(v) for v in args.size.split("x"))
    scene = scenes()[args.scene]()

    if args.serve is not None:
        viewer = LiveViewer(scene, w, h, distance=args.distance)
        server = serve(viewer, args.serve)
        print(f"live view: http://127.0.0.1:{server.server_address[1]}/")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    if args.orbit <= 0:
        img = np.asarray(sk.render(scene, w, h, camera_position=(-2, 2, 4)))
        save(args.out, img)
        print(args.out)
        return 0

    root, ext = os.path.splitext(args.out)
    marcher = sk.RayMarcher(w, h, scene)
    for i in range(args.orbit):
        a = 2.0 * math.pi * i / args.orbit
        view = sk.look_at(
            (args.distance * math.sin(a), 2.0, args.distance * math.cos(a)),
            (0, 0, 0),
            (0, 1, 0),
        )
        frame = np.asarray(marcher.render(camera=view))
        path = f"{root}-{i:03d}{ext}"
        save(path, frame)
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
