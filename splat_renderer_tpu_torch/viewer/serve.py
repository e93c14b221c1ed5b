"""Interactive browser viewer: mouse-orbit an engine over HTTP.

Counterpart of `splat_renderer_tpu/viewer/serve.py`.  The engine is
headless; this serves an interaction loop over HTTP: a single-page client
maps drag/wheel gestures to orbit parameters (the speeds of
`camera.OrbitCameraController`) and streams freshly rendered frames.

Pipelined, not serial: a render thread continuously renders the latest
requested camera state, a transfer thread copies the newest finished frame
to the host, and HTTP handler threads (ThreadingHTTPServer) encode and ship
it: the render of frame i+1 overlaps the transfer and encoding of frame i.
Stale camera states are dropped (latest wins), as a browser's animation
loop coalesces input events.

The frame is quantized to uint8, and in half mode 2x2-pooled first, on the
engine's device, so the device-to-host copy moves a quarter (a sixteenth) of
the float image's bytes.  For a CUDA engine the copy runs on a stream of its
own into pinned host memory, so it does not queue behind the next frame's
kernels.

Transfer encodings: PNG (default, works in any <img>) or raw RGB (?raw=1,
drawn with canvas putImageData: no encoding on the hot path; the page picks
raw).  The HUD shows the server's render ms, encode ms, the client's FPS,
and a one-off per-stage device profile (`Engine.stage_profile`, CUDA
events).

Stdlib-only (http.server).

Usage:
    from splat_renderer_tpu_torch.viewer.serve import serve
    serve(engine, port=8000)      # then open http://localhost:8000
"""

from __future__ import annotations

import io
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..camera import Camera, camera_tensors
from ..render.pipeline import Engine
from ..utils.image import to_uint8_rows, unflatten_rows

_PAGE = """<!doctype html>
<html><head><title>splat_renderer_tpu_torch</title><style>
body { margin:0; background:#0d0d1a; overflow:hidden; }
canvas { width:100vw; height:100vh; object-fit:contain; display:block; cursor:grab; }
#hud { position:fixed; top:8px; left:8px; color:#8fa; font:12px monospace;
       white-space:pre; }
</style></head><body>
<canvas id="v" width="__W__" height="__H__"></canvas><div id="hud"></div>
<script>
let az = 0.5, el = 0.5, dist = 3.0, px = 0, py = 0, half = 0;
let t0 = performance.now(), seq = 0, frames = 0, fpsT = performance.now(), fps = 0;
const animate = __ANIMATE__;
const cv = document.getElementById('v'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
const W = cv.width, H = cv.height;
const off = document.createElement('canvas'), offctx = off.getContext('2d');
// 'h' toggles half-res serving: the frame is 2x2-pooled on the device, so the
// wire carries a quarter of the bytes: the knob for remote/tunneled links
window.onkeydown = e => { if (e.key === 'h') { half = 1 - half; dirty = true; } };
const clamp = (x, a, b) => Math.max(a, Math.min(b, x));
let drag = null, panning = false, dirty = true;
// left drag rotates; middle/right drag pans (camera.OrbitCameraController's speeds)
cv.onmousedown = e => {
  drag = [e.clientX, e.clientY]; panning = e.button !== 0; e.preventDefault();
};
cv.oncontextmenu = e => e.preventDefault();
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (panning) {                                 // PAN_SPEED
    px -= dx * 0.002; py += dy * 0.002;
  } else {                                       // ROTATE_SPEED
    az -= dx * 0.005;
    el = clamp(el + dy * 0.005, -1.56, 1.56);
  }
  drag = [e.clientX, e.clientY]; dirty = true;
};
window.onwheel = e => { dist = clamp(dist + e.deltaY * 0.001 * dist, 0.5, 20); dirty = true; };
async function loop() {
  // keep exactly one fetch inflight; the server's render thread already
  // pipelines the NEXT frame while this one encodes/ships
  while (true) {
    if (!dirty && !animate) { await new Promise(r => setTimeout(r, 8)); continue; }
    dirty = false;
    const t = (performance.now() - t0) / 1000;
    const r = await fetch(`/frame?az=${az}&el=${el}&d=${dist}&px=${px}&py=${py}&t=${t}&seq=${seq}&raw=1&half=${half}`);
    seq = parseInt(r.headers.get('x-seq') || '0');
    const ms = r.headers.get('x-render-ms'), stages = r.headers.get('x-stage-ms') || '';
    const fw = parseInt(r.headers.get('x-w') || W), fh = parseInt(r.headers.get('x-h') || H);
    const buf = new Uint8Array(await r.arrayBuffer());
    const id = offctx.createImageData(fw, fh);
    for (let i = 0, j = 0; i < buf.length; i += 3, j += 4) {
      id.data[j] = buf[i]; id.data[j+1] = buf[i+1]; id.data[j+2] = buf[i+2]; id.data[j+3] = 255;
    }
    off.width = fw; off.height = fh;
    offctx.putImageData(id, 0, 0);
    if (fw === W && fh === H) { ctx.drawImage(off, 0, 0); }
    else { ctx.imageSmoothingEnabled = true; ctx.drawImage(off, 0, 0, W, H); }
    frames++;
    const now = performance.now();
    if (now - fpsT > 500) { fps = frames * 1000 / (now - fpsT); frames = 0; fpsT = now; }
    hud.textContent = `served ${fps.toFixed(1)} fps  render ${ms} ms\\n${stages}\\naz=${az.toFixed(2)} el=${el.toFixed(2)} d=${dist.toFixed(2)} pan=(${px.toFixed(2)},${py.toFixed(2)})`;
  }
}
loop();
</script></body></html>"""


def pool_half(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (H//2, W//2, 3): the mean of each 2x2 block, on the
    tensor's device.  Odd sizes are cropped to even first, so the four phase
    slices agree in shape."""
    he, we = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    x = img[:he, :we]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


class _RenderLoop:
    """Latest-wins render thread: double-buffers engine frames.

    `request(state)` stores the newest desired camera state; the thread
    renders whenever the desired state differs from the last rendered one
    and publishes (seq, rgb_u8, render_ms).  `latest(min_seq, timeout)`
    blocks until a frame newer than min_seq exists: handler threads encode
    and ship it while the loop is already rendering the next.

    An exception in either thread is kept in `error` and stops the loop, so
    a caller (the handler, a test) can see it; it is never swallowed.
    """

    def __init__(self, engine: Engine,
                 animate: Optional[Callable[[float], None]] = None,
                 profile_stages: bool = True):
        self.engine = engine
        self.device = torch.device(getattr(engine, "device", "cpu"))
        self.animate = animate
        self.profile_stages = profile_stages
        self.half = False  # serve 2x2-pooled half-res frames (remote links)
        self._cv = threading.Condition()
        self._desired = None
        self._rendered_state = None
        self._dev_frame = None  # (seq, device u8 (H, W*3), width, ms, ready event)
        self._frame = None  # (seq, np.uint8 (H, W, 3), render_ms)
        self._seq = 0
        self._stop = False
        self.error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._guard, args=(self._run,), daemon=True)
        # dedicated transfer thread: copies the newest device frame to the
        # host while the render thread produces the next one, so the serve
        # cycle is max(render, copy) instead of their sum
        self._xthread = threading.Thread(target=self._guard, args=(self._xfer,), daemon=True)
        self.stage_ms = {}  # one-off device stage profile (filled lazily)
        self._copy_stream = None  # the transfer thread's CUDA stream (lazy)

    def start(self):
        self._thread.start()
        self._xthread.start()
        return self

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        self._xthread.join(timeout=5)

    def _guard(self, body):
        try:
            body()
        except Exception as e:  # the threads' boundary: kept for the caller, loop stops
            with self._cv:
                self.error = e
                self._stop = True
                self._cv.notify_all()

    def request(self, state: tuple):
        with self._cv:
            self._desired = state
            self._cv.notify_all()

    def latest(self, min_seq: int, state: tuple, timeout: float = 30.0):
        """Newest frame strictly after min_seq, or the current frame if
        `state` is already the rendered one (idempotent refetch)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while not (
                self._frame is not None
                and (self._frame[0] > min_seq
                     or (self._rendered_state == state
                         and self._frame[0] == self._seq))
            ):
                rem = deadline - time.monotonic()
                if rem <= 0 or self._stop:
                    return self._frame  # best effort (may be None)
                self._cv.wait(rem)
            return self._frame

    def _camera_arrays(self, state):
        az, el, dist, px, py, t = state[:6]
        cam = Camera(aspect=self.engine.rcfg.width / self.engine.rcfg.height)
        cam.azimuth = az
        cam.elevation = float(np.clip(el, -cam.MAX_ELEVATION,
                                      cam.MAX_ELEVATION))
        cam.distance = float(np.clip(dist, cam.MIN_DISTANCE,
                                     cam.MAX_DISTANCE))
        cam.target = np.zeros(3, np.float32)
        if px or py:
            cam.pan(px, py)
        return camera_tensors(cam.arrays(t), self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and (
                    self._desired is None
                    or self._desired == self._rendered_state
                ):
                    self._cv.wait()
                if self._stop:
                    return
                state = self._desired
            t = state[5]  # (az, el, dist, px, py, t[, half])
            if self.animate is not None:
                self.animate(t)
            camera = self._camera_arrays(state)
            seq = self._seq + 1
            t0 = time.perf_counter()
            img = self.engine.frame(camera, self._generator(seq))
            # quantize on the device and hand over u8 flat rows; half mode
            # 2x2-pools on the device first (toggle 'h' in the page or pass
            # half=1 on /frame)
            half = bool(state[6]) if len(state) > 6 else self.half
            w = self.engine.rcfg.width // (2 if half else 1)
            arr_dev = to_uint8_rows(pool_half(img) if half else img)
            ready = None
            if arr_dev.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(arr_dev.device))
                ready.synchronize()  # render_ms is the frame's time, not its enqueue
            ms = (time.perf_counter() - t0) * 1e3
            # publish BEFORE the one-off stage profile, which renders
            # several more frames: holding the first frame back behind it
            # would make latest() time out and the handler answer 503
            with self._cv:
                self._seq = seq
                self._dev_frame = (seq, arr_dev, w, ms, ready)
                self._rendered_state = state
                self._cv.notify_all()
            if self.profile_stages and not self.stage_ms:
                try:  # one-off device profile, for the HUD only
                    self.stage_ms = self.engine.stage_profile(
                        camera, self._generator(0)) or {"n/a": 0.0}
                except Exception:
                    self.stage_ms = {"n/a": 0.0}

    def _to_host(self, arr_dev: torch.Tensor, ready) -> np.ndarray:
        """Device u8 rows -> host array.  On CUDA: into pinned memory, on a
        stream of this thread's own that waits for the frame's event."""
        if arr_dev.device.type != "cuda":
            return arr_dev.numpy()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(arr_dev.device)
        stream = self._copy_stream
        host = torch.empty(arr_dev.shape, dtype=arr_dev.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            arr_dev.record_stream(stream)  # keep the block until the copy ran
            host.copy_(arr_dev, non_blocking=True)
        stream.synchronize()
        return host.numpy()

    def _xfer(self):
        """Transfer thread: device-to-host copy of the newest rendered
        frame, pipelined against the render thread.  Stale device frames
        are skipped (latest wins at the transfer stage too)."""
        last = 0
        while True:
            with self._cv:
                while not self._stop and (
                    self._dev_frame is None or self._dev_frame[0] <= last
                ):
                    self._cv.wait()
                if self._stop:
                    return
                seq, arr_dev, w, ms, ready = self._dev_frame
            arr = unflatten_rows(self._to_host(arr_dev, ready), w)  # outside the lock
            last = seq
            with self._cv:
                # keep only the newest host frame (a newer transfer can't
                # overtake us: this is the only writer of _frame)
                self._frame = (seq, arr, ms)
                self._cv.notify_all()


def make_server(
    engine: Engine,
    port: int = 8000,
    animate: Optional[Callable[[float], None]] = None,
    host: str = "127.0.0.1",
    profile_stages: bool = True,
) -> ThreadingHTTPServer:
    """Build the viewer HTTP server without starting it.

    port=0 binds an ephemeral port (read it from `.server_address[1]`) —
    the test surface; `serve` is the blocking entry point.  The attached
    render loop starts with the server thread's first /frame request and is
    stopped by `server.render_loop.stop()` (serve does both).

    profile_stages=False skips the one-off HUD stage profile entirely: a
    served-FPS measurement uses it so the profile's frames never contend
    with the frames being timed.
    """
    loop = _RenderLoop(engine, animate, profile_stages).start()
    page = (_PAGE
            .replace("__W__", str(engine.rcfg.width))
            .replace("__H__", str(engine.rcfg.height))
            .replace("__ANIMATE__", "true" if animate else "false"))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path != "/frame":
                self.send_response(404)
                self.end_headers()
                return
            q = parse_qs(url.query)

            def f(name, default):
                return float(q.get(name, [default])[0])

            state = (f("az", 0.5), f("el", 0.5), f("d", 3.0),
                     f("px", 0.0), f("py", 0.0), f("t", 0.0),
                     q.get("half", ["0"])[0] == "1")
            min_seq = int(f("seq", 0))
            raw = q.get("raw", ["0"])[0] == "1"
            loop.request(state)
            got = loop.latest(min_seq, state)
            if loop.error is not None:
                body = f"render loop failed: {loop.error!r}".encode()
                self.send_response(500)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if got is None:
                self.send_response(503)
                self.end_headers()
                return
            seq, arr, ms = got
            t1 = time.perf_counter()
            if raw:
                body = arr.tobytes()
                ctype = "application/octet-stream"
            else:
                buf = io.BytesIO()
                _write_png_bytes(buf, arr)
                body = buf.getvalue()
                ctype = "image/png"
            encode_ms = (time.perf_counter() - t1) * 1e3
            stages = " ".join(f"{k}={v:.2f}" for k, v in loop.stage_ms.items())
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Seq", str(seq))
            # the served frame's geometry (half mode pools 2x2 on the device)
            self.send_header("X-W", str(arr.shape[1]))
            self.send_header("X-H", str(arr.shape[0]))
            self.send_header("X-Render-Ms", f"{ms:.1f}")
            self.send_header(
                "X-Stage-Ms",
                f"encode={encode_ms:.1f} | device stages: {stages}",
            )
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    server.render_loop = loop  # expose for tests/shutdown
    return server


def serve(
    engine: Engine,
    port: int = 8000,
    animate: Optional[Callable[[float], None]] = None,
    host: str = "127.0.0.1",
) -> None:
    """Serve the interactive viewer (blocking)."""
    httpd = make_server(engine, port, animate, host)
    print(f"splat_renderer_tpu_torch viewer: http://{host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    finally:
        httpd.render_loop.stop()


def _write_png_bytes(buf: io.BytesIO, arr: np.ndarray) -> None:
    import struct
    import zlib

    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    buf.write(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 1))
        + chunk(b"IEND", b"")
    )
