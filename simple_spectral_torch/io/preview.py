"""Live render preview, the ``--window`` feature (a copy of
``simple_spectral_tpu.io.preview`` for the PyTorch port).

The reference opens a GLFW window and blits the accumulating framebuffer
with ``glDrawPixels`` once per second (reference src/main.cpp:51-52,271-334
+ src/framebuffer.cpp:178-187).  A render usually runs on a remote,
display-less machine, so the equivalents here are:

* :class:`HttpPreview` -- a tiny stdlib HTTP server on a background thread
  serving the latest frame as PNG plus an auto-refreshing page; point any
  browser at ``http://host:port/``.
* :class:`AnsiPreview` -- draws the frame directly into the terminal with
  24-bit-color half-block characters (two pixel rows per text row).

Both consume the u8 RGBA frames of :meth:`ProgressiveRenderer.image_u8`,
top-to-bottom rows.  The PNG is encoded by the port's own codec
(``io/image.py``), so no imaging library is needed.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Optional

import numpy as np

__all__ = ["AnsiPreview", "HttpPreview", "open_preview"]


class HttpPreview:
    """Serve the latest frame over HTTP from a daemon thread.

    Routes: ``/`` (auto-refreshing page), ``/frame.png`` (latest frame),
    ``/status.json`` ({"spp_done", "spp_total", "frame_id"}).
    ``port=0`` binds an ephemeral port (see :attr:`port` after init).
    """

    def __init__(self, port: int = 8000, host: str = "127.0.0.1", quiet: bool = False):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = threading.Lock()
        self._png: Optional[bytes] = None
        self._status = {"spp_done": 0, "spp_total": 0, "frame_id": 0}
        preview = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no per-request stderr spam
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/frame.png":
                    with preview._lock:
                        png = preview._png
                    if png is None:
                        self.send_error(404, "no frame yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(png)
                elif path == "/status.json":
                    with preview._lock:
                        body = json.dumps(preview._status).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        if not quiet:
            print(f"live preview: http://{host}:{self.port}/", file=sys.stderr)

    def update(self, frame_u8: np.ndarray, spp_done: int = 0, spp_total: int = 0):
        """frame_u8: u8 [H, W, 3|4], top-to-bottom rows."""
        from simple_spectral_torch.io.image import encode_png_rgba

        frame = np.asarray(frame_u8, np.uint8)
        if frame.shape[-1] == 3:
            frame = np.concatenate([frame, np.full(frame.shape[:-1] + (1,), 255, np.uint8)], axis=-1)
        png = encode_png_rgba(frame)
        with self._lock:
            self._png = png
            self._status = {
                "spp_done": int(spp_done),
                "spp_total": int(spp_total),
                "frame_id": self._status["frame_id"] + 1,
            }

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


_PAGE = """<!doctype html><meta charset="utf-8"><title>simple-spectral-torch</title>
<style>body{background:#111;color:#ccc;font:14px monospace;text-align:center}
img{image-rendering:pixelated;max-width:95vw;max-height:85vh;margin-top:1em}</style>
<div id="s">waiting for first frame...</div><img id="f">
<script>
async function tick(){
  try{
    const st=await (await fetch('/status.json')).json();
    if(st.frame_id!==window._id){
      window._id=st.frame_id;
      document.getElementById('f').src='/frame.png?'+st.frame_id;
      document.getElementById('s').textContent=st.spp_done+' / '+st.spp_total+' spp';
    }
  }catch(e){}
  setTimeout(tick, 1000);
}
tick();
</script>"""


class AnsiPreview:
    """Draw the frame into a truecolor terminal with U+2580 half blocks
    (each text cell shows two vertically stacked pixels: foreground = upper,
    background = lower), downsampled to at most (max_cols, 2*max_rows)."""

    def __init__(self, max_cols: int = 0, max_rows: int = 0, out=None):
        self.out = out if out is not None else sys.stderr
        if not (max_cols and max_rows):
            import shutil

            ts = shutil.get_terminal_size((80, 24))
            max_cols = max_cols or max(16, ts.columns - 2)
            max_rows = max_rows or max(8, ts.lines - 3)
        self.max_cols, self.max_rows = max_cols, max_rows
        self._drawn_rows = 0

    def update(self, frame_u8: np.ndarray, spp_done: int = 0, spp_total: int = 0):
        img = np.asarray(frame_u8)[..., :3]
        h, w = img.shape[:2]
        # integer-stride downsample to fit (max_cols, 2*max_rows) pixels
        step = max(1, (w + self.max_cols - 1) // self.max_cols,
                   (h + 2 * self.max_rows - 1) // (2 * self.max_rows))
        img = img[::step, ::step]
        if img.shape[0] % 2:
            img = img[:-1] if img.shape[0] > 1 else np.repeat(img, 2, axis=0)
        top, bot = img[0::2], img[1::2]
        lines = []
        for tr, br in zip(top, bot):
            cells = [
                f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                for t, b in zip(tr, br)
            ]
            lines.append("".join(cells) + "\x1b[0m")
        status = f"{spp_done} / {spp_total} spp" if spp_total else ""
        if self._drawn_rows:  # redraw in place
            self.out.write(f"\x1b[{self._drawn_rows}A")
        self.out.write("\n".join(lines) + "\n" + status + "\n")
        self.out.flush()
        self._drawn_rows = len(lines) + 1

    def close(self):
        pass


def open_preview(kind: str = "auto", port: int = 8000, quiet: bool = False):
    """Factory: ``http`` | ``ansi`` | ``auto`` (http, the remote-native
    default: a render host rarely has a local display or a truecolor tty)."""
    if kind in ("auto", "http"):
        return HttpPreview(port=port, quiet=quiet)
    if kind == "ansi":
        return AnsiPreview()
    raise ValueError(f"unknown preview kind {kind!r} (http | ansi | auto)")
