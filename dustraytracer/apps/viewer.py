"""Interactive progressive viewer — the editor shell, headless.

The reference's interactive surface is an ImGui/GLFW desktop app
(`DustRayTracer/src/Application/private/Application.cpp:28-120` frame
loop; `src/Editor/EditorLayer.cpp:75-321` panels). A GPU server is
headless, so the same capabilities are served as a local web app over stdlib http.server — no extra dependencies, drive it with any
browser:

- progressive accumulation with live display and sample cap
  (`Renderer.cu:80-117`), reset on any camera/settings change
  (`EditorLayer.cpp:233-284,424`),
- WASD/QE + mouse-drag fly camera (`EditorLayer.cpp:324-417`),
- settings panel: bounces, max samples, sun/sky, tonemap/gamma, debug
  views, shading model (`EditorLayer.cpp:233-284`),
- developer metrics: per-sample device ms, min/avg/max Hz, rays/s,
  scene statistics (`EditorLayer.cpp:100-231`),
- console log window (`EditorLayer.cpp:308-311`),
- PNG export of the current framebuffer (`EditorLayer.cpp:23-31,85-96`),
- the reference's five UI themes (`Editor/Theme/EditorTheme.cpp`).

Run:  python -m dustraytracer.apps.viewer --scene cornell_box.glb \
          [--size 512x512] [--port 8060] [--cpu]

Architecture: one render thread owns all device work (a jitted
per-sample step; re-jit only when settings/size change); the HTTP
threads only swap pytrees and enqueue state mutations under a lock —
mutation-then-reset has the same semantics as the reference's
"every ImGui widget write resets accumulation".
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

THEMES = {  # parity: ImGuiThemes::{nighttheme,UE4,vs,dark,embraceTheDarkness}
    "night": {"bg": "#10131a", "panel": "#1a1f2b", "accent": "#4f8cff",
              "text": "#dce3f0"},
    "ue4": {"bg": "#161616", "panel": "#242424", "accent": "#c87d2f",
            "text": "#e0e0e0"},
    "vs": {"bg": "#1e1e1e", "panel": "#252526", "accent": "#007acc",
           "text": "#d4d4d4"},
    "dark": {"bg": "#0d0d0d", "panel": "#1b1b1b", "accent": "#888888",
             "text": "#cccccc"},
    "darkness": {"bg": "#000000", "panel": "#121212", "accent": "#b04ae0",
                 "text": "#bdbdbd"},
}

MUTABLE_SETTINGS = (
    "bounces", "max_samples", "enable_tonemap", "enable_gamma",
    "enable_sunlight", "sun_intensity", "sky_intensity", "sun_azimuth",
    "sun_elevation", "alpha_test", "russian_roulette", "shading",
    "smooth_shading", "tex_filter",
)

# live-mutable camera parameters (reference settings-panel parity:
# `EditorLayer.cpp:265-268` drags vfov/focus/defocus/exposure with an
# accumulation reset on change)
MUTABLE_CAMERA = ("vfov_deg", "focus_dist", "defocus_angle", "exposure")


class ViewerState:
    """Shared mutable state; everything device-side happens in run()."""

    def __init__(self, scene, camera, settings, width, height, speed):
        self.lock = threading.Lock()
        self.scene = scene
        self.camera = camera
        self.settings = settings
        self.width = width
        self.height = height
        self.speed = speed
        self.dirty = True          # pending reset (camera/settings change)
        self.running = True
        self.image = np.zeros((height, width, 3), np.float32)
        self.samples = 0
        self.sample_ms = 0.0
        self.console = []
        self.frame_stats = None
        self.save_request = None
        self.saved = []
        self.log(f"viewer up — scene with {scene.n_tris} tris")

    def log(self, msg):
        self.console.append(f"[{time.strftime('%H:%M:%S')}] {msg}")
        del self.console[:-200]

    # ---- render thread ----------------------------------------------
    def run(self):
        import jax
        import jax.numpy as jnp

        from dustraytracer.render.film import (film_add, film_image,
                                               film_init)
        from dustraytracer.render.integrator import render_sample
        from dustraytracer.scene.settings import LightParams
        from dustraytracer.utils.image import save_png
        from dustraytracer.utils.profiling import FrameStats

        self.frame_stats = FrameStats()
        film = None
        step = None
        key = None

        while self.running:
            with self.lock:
                cam = self.camera
                settings = self.settings
                w, h = self.width, self.height
                dirty, self.dirty = self.dirty, False
                save_to, self.save_request = self.save_request, None

            if save_to and film is not None:
                save_png(save_to, np.clip(np.asarray(film_image(film)),
                                          0, 1))
                with self.lock:
                    self.saved.append(save_to)
                    self.log(f"saved {save_to}")

            new_key = (w, h, settings)
            if step is None or new_key != key:
                key = new_key
                lights = LightParams.from_settings(settings)

                def step(cam, film, frame, _s=settings, _w=w, _h=h,
                         _l=lights):
                    sample = render_sample(self.scene, cam, _l, frame,
                                           width=_w, height=_h, settings=_s)
                    return film_add(film, sample)

                step = jax.jit(step)
                dirty = True

            if dirty:
                film = film_init(w, h)
                with self.lock:
                    self.samples = 0

            if int(film.frame) >= settings.max_samples:
                time.sleep(0.05)  # sample-cap gate (`Renderer.cu:82`)
                continue

            self.frame_stats.begin()
            t0 = time.perf_counter()
            film = step(cam, film, jnp.uint32(int(film.frame)))
            jax.block_until_ready(film)
            ms = (time.perf_counter() - t0) * 1e3
            self.frame_stats.end()
            img = np.asarray(film_image(film))
            with self.lock:
                if not self.dirty:  # drop the frame if state changed mid-render
                    self.image = img
                    self.samples = int(film.frame)
                    self.sample_ms = ms

    # ---- mutations (HTTP threads) -----------------------------------
    def apply(self, cmd: dict):
        from dustraytracer.scene.camera import (move_camera,
                                                rotate_camera)

        with self.lock:
            if "move" in cmd:
                d = np.asarray(cmd["move"], np.float32) * self.speed
                self.camera = move_camera(self.camera, d)
                self.dirty = True
            if "rotate" in cmd:
                yaw, pitch = cmd["rotate"]
                self.camera = rotate_camera(self.camera, float(yaw),
                                            float(pitch))
                self.dirty = True
            if "camera" in cmd:
                import jax.numpy as jnp

                kw = {k: jnp.float32(float(v))
                      for k, v in cmd["camera"].items()
                      if k in MUTABLE_CAMERA}
                if kw:
                    self.camera = self.camera.replace(**kw)
                    self.dirty = True
                    self.log(f"camera: { {k: float(v) for k, v in kw.items()} }")
            if "speed" in cmd:
                self.speed = float(cmd["speed"])
                self.log(f"move speed: {self.speed:g}")
            if "set" in cmd:
                kw = {}
                for k, v in cmd["set"].items():
                    if k in MUTABLE_SETTINGS:
                        kw[k] = v
                    elif k == "debug_view":
                        from dustraytracer.scene.settings import (
                            DebugMode, RenderMode)
                        if v:
                            kw["render_mode"] = RenderMode.DEBUG
                            kw["debug_mode"] = DebugMode[v.upper()]
                        else:
                            kw["render_mode"] = RenderMode.NORMAL
                if kw:
                    self.settings = self.settings.replace(**kw)
                    self.dirty = True
                    self.log(f"settings: {kw}")
            if "resize" in cmd:
                # resize-reactive render target (`Renderer::ResizeBuffer`,
                # Core/Renderer.cu:29-78): new film + fresh executable for
                # the new shape, accumulation restarts
                w, h = (int(x) for x in cmd["resize"])
                if 16 <= w <= 4096 and 16 <= h <= 4096:
                    self.width, self.height = w, h
                    self.dirty = True
                    self.log(f"resized to {w}x{h}")
            if cmd.get("reset"):
                self.dirty = True
                self.log("accumulation reset")
            if cmd.get("save"):
                self.save_request = str(cmd["save"])

    def snapshot(self) -> dict:
        with self.lock:
            s = self.settings
            stats = (self.frame_stats.report()
                     if self.frame_stats and self.frame_stats.frames
                     else {})
            rays = (self.width * self.height * s.bounces
                    * (2 if s.enable_sunlight else 1))
            return {
                "size": [self.width, self.height],
                "samples": self.samples,
                "max_samples": s.max_samples,
                "sample_ms": round(self.sample_ms, 2),
                "mrays_per_s": round(rays / max(self.sample_ms, 1e-3)
                                     / 1e3, 3),
                "freq": stats,
                "scene": {"triangles": self.scene.n_tris,
                          "materials": self.scene.n_materials,
                          "textures": self.scene.n_textures,
                          "bvh_nodes": self.scene.n_nodes},
                "settings": {
                    "bounces": s.bounces, "max_samples": s.max_samples,
                    "enable_tonemap": s.enable_tonemap,
                    "enable_gamma": s.enable_gamma,
                    "enable_sunlight": s.enable_sunlight,
                    "sun_intensity": float(s.sun_intensity),
                    "sky_intensity": float(s.sky_intensity),
                    "shading": s.shading,
                    "alpha_test": s.alpha_test,
                    "smooth_shading": s.smooth_shading,
                    "tex_filter": s.tex_filter,
                    "debug_view": (s.debug_mode.name.lower()
                                   if s.render_mode.name == "DEBUG"
                                   else ""),
                },
                "camera": {
                    "position": np.asarray(self.camera.position).tolist(),
                    "vfov_deg": float(np.asarray(self.camera.vfov_deg)),
                    "focus_dist": float(np.asarray(self.camera.focus_dist)),
                    "defocus_angle": float(
                        np.asarray(self.camera.defocus_angle)),
                    "exposure": float(np.asarray(self.camera.exposure)),
                    "speed": self.speed,
                },
                "console": list(self.console),
                "saved": list(self.saved),
            }

    def frame_png(self) -> bytes:
        from dustraytracer.utils.image import encode_png, to_uint8

        with self.lock:
            img = self.image
        return encode_png(to_uint8(img[::-1]))


PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>dustraytracer</title><style>
:root { --bg:%(bg)s; --panel:%(panel)s; --accent:%(accent)s;
        --text:%(text)s; }
body { margin:0; background:var(--bg); color:var(--text);
       font:13px/1.45 system-ui, sans-serif; display:flex; height:100vh; }
#view { flex:1; display:flex; align-items:center; justify-content:center; }
#view img { max-width:100%%; max-height:100%%; image-rendering:pixelated;
            outline:1px solid var(--panel); }
#side { width:330px; overflow-y:auto; background:var(--panel);
        padding:10px 14px; }
h3 { margin:12px 0 6px; color:var(--accent); font-size:12px;
     text-transform:uppercase; letter-spacing:.08em; }
table { width:100%%; border-collapse:collapse; }
td { padding:1px 4px; } td:last-child { text-align:right;
     font-variant-numeric:tabular-nums; }
label { display:flex; justify-content:space-between; margin:3px 0;
        align-items:center; gap:6px; }
input,select,button { background:var(--bg); color:var(--text);
  border:1px solid #444; border-radius:3px; padding:2px 6px; }
button { cursor:pointer; } button:hover { border-color:var(--accent); }
#console { background:var(--bg); height:110px; overflow-y:auto;
  font:11px/1.4 monospace; padding:4px; white-space:pre-wrap; }
small { opacity:.6 }
</style></head><body>
<div id="view"><img id="fb" tabindex="0"></div>
<div id="side">
  <h3>Render</h3><table id="metrics"></table>
  <h3>Scene</h3><table id="scene"></table>
  <h3>Settings</h3><div id="settings"></div>
  <h3>Camera <small>(click image: WASD/QE move, drag look)</small></h3>
  <table id="camera"></table>
  <div id="camctl"></div>
  <h3>Actions</h3>
  <button onclick="api({reset:true})">Reset accumulation</button>
  <button onclick="api({save:'viewer_render.png'})">Save PNG</button>
  <label>Theme <select id="theme" onchange="setTheme(this.value)">
  %(theme_options)s</select></label>
  <h3>Console</h3><div id="console"></div>
</div>
<script>
const fb = document.getElementById('fb');
function api(cmd) { fetch('/api', {method:'POST', body:JSON.stringify(cmd)}); }
function setTheme(t) { fetch('/theme/'+t).then(()=>location.reload()); }
function row(t, kv) { t.innerHTML = Object.entries(kv).map(
  ([k,v])=>`<tr><td>${k}</td><td>${v}</td></tr>`).join(''); }
async function refresh() {
  fb.src = '/frame.png?' + Date.now();
  const s = await (await fetch('/state')).json();
  row(document.getElementById('metrics'), {
    'samples': s.samples + ' / ' + s.max_samples,
    'device ms/sample': s.sample_ms, 'Mrays/s': s.mrays_per_s,
    'Hz min/avg/max': s.freq.hz_min!=null ?
      `${s.freq.hz_min} / ${s.freq.hz_avg} / ${s.freq.hz_max}` : '—'});
  row(document.getElementById('scene'), s.scene);
  row(document.getElementById('camera'), {
    position: s.camera.position.map(x=>x.toFixed(2)).join(', ')});
  const ce = document.getElementById('camctl');
  if (!ce.dataset.built) {
    ce.dataset.built = 1;
    const c = s.camera;
    const cnum = (k,step)=>`<label>${k}<input type=number step=${step}
      value="${c[k]}" onchange='api({camera:{${k}:+this.value}})'></label>`;
    ce.innerHTML = cnum('vfov_deg',1)+cnum('focus_dist',0.1)
      +cnum('defocus_angle',0.1)+cnum('exposure',0.1)
      +`<label>move speed<input type=number step=0.01 value="${c.speed}"
        onchange='api({speed:+this.value})'></label>`;
  }
  const el = document.getElementById('settings');
  if (!el.dataset.built) {
    el.dataset.built = 1;
    const set = s.settings;
    const num = (k,step)=>`<label>${k}<input type=number step=${step}
      value="${set[k]}" onchange='api({set:{${k}:+this.value}})'></label>`;
    const chk = (k)=>`<label>${k}<input type=checkbox ${set[k]?'checked':''}
      onchange='api({set:{${k}:this.checked}})'></label>`;
    el.innerHTML = num('bounces',1)+num('max_samples',10)
      +num('sun_intensity',1)+num('sky_intensity',1)
      +chk('enable_tonemap')+chk('enable_gamma')+chk('enable_sunlight')
      +chk('alpha_test')+chk('smooth_shading')
      +`<label>size<input size=9 value="${s.size[0]}x${s.size[1]}"
        onchange='const p=this.value.split("x");api({resize:[+p[0],+p[1]]})'></label>`
      +`<label>tex filter<select onchange='api({set:{tex_filter:this.value}})'>
        <option ${set.tex_filter=='point'?'selected':''}>point</option>
        <option ${set.tex_filter=='bilinear'?'selected':''}>bilinear</option></select></label>`
      +`<label>shading<select onchange='api({set:{shading:this.value}})'>
        <option ${set.shading=='reference'?'selected':''}>reference</option>
        <option ${set.shading=='pbr'?'selected':''}>pbr</option></select></label>`
      +`<label>debug view<select
         onchange='api({set:{debug_view:this.value}})'>
        <option value="">off</option>
        ${['albedo','normal','barycentric','uvs','bvh'].map(v=>
          `<option ${set.debug_view==v?'selected':''}>${v}</option>`).join('')}
        </select></label>`;
  }
  document.getElementById('console').textContent = s.console.join('\\n');
}
setInterval(refresh, 500); refresh();
const keymap = {w:[0,0,-1], s:[0,0,1], a:[-1,0,0], d:[1,0,0],
                q:[0,-1,0], e:[0,1,0]};
window.addEventListener('keydown', ev => {
  const m = keymap[ev.key.toLowerCase()];
  if (m) api({move: m});
});
let drag = null;
fb.addEventListener('mousedown', ev => drag = [ev.clientX, ev.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', ev => {
  if (!drag) return;
  const dx = ev.clientX - drag[0], dy = ev.clientY - drag[1];
  drag = [ev.clientX, ev.clientY];
  api({rotate: [-dx * 0.004, -dy * 0.004]});
});
</script></body></html>"""


def make_handler(state: ViewerState, theme_holder):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                self._send(200, state.frame_png(), "image/png")
            elif self.path.startswith("/state"):
                self._send(200, json.dumps(state.snapshot()).encode(),
                           "application/json")
            elif self.path.startswith("/theme/"):
                name = self.path.split("/")[-1]
                if name in THEMES:
                    theme_holder[0] = name
                self._send(200, b"ok", "text/plain")
            else:
                theme = THEMES[theme_holder[0]]
                opts = "".join(
                    f'<option {"selected" if k == theme_holder[0] else ""}>'
                    f"{k}</option>" for k in THEMES)
                page = PAGE % {**theme, "theme_options": opts}
                self._send(200, page.encode(), "text/html")

        def do_POST(self):
            if self.path.startswith("/api"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    cmd = json.loads(self.rfile.read(n) or b"{}")
                    state.apply(cmd)
                    self._send(200, b"ok", "text/plain")
                except Exception as e:  # surface errors to the console
                    state.log(f"api error: {e}")
                    self._send(400, str(e).encode(), "text/plain")
            else:
                self._send(404, b"", "text/plain")

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Interactive progressive viewer (browser UI)")
    p.add_argument("--scene", required=True)
    p.add_argument("--size", default="512x512")
    p.add_argument("--port", type=int, default=8060)
    p.add_argument("--camera-pos", default=None)
    p.add_argument("--look-at", default=None)
    p.add_argument("--vfov", type=float, default=60.0)
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--max-samples", type=int, default=500)
    p.add_argument("--speed", type=float, default=None,
                   help="camera move step (default: 2%% of scene size)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from dustraytracer.scene import load_scene, make_camera
    from dustraytracer.scene.settings import RenderSettings

    w, h = (int(x) for x in args.size.split("x"))
    scene = load_scene(args.scene)
    lo = np.asarray(scene.node_min[0])
    hi = np.asarray(scene.node_max[0])
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    pos = ([float(x) for x in args.camera_pos.split(",")]
           if args.camera_pos else center + np.array([0, .15, .8]) * size)
    look = ([float(x) for x in args.look_at.split(",")]
            if args.look_at else center)
    camera = make_camera(position=pos, look_at=look, vfov_deg=args.vfov)
    settings = RenderSettings(bounces=args.bounces,
                              max_samples=args.max_samples)
    state = ViewerState(scene, camera, settings, w, h,
                        speed=args.speed or 0.02 * size)

    t = threading.Thread(target=state.run, daemon=True)
    t.start()

    theme_holder = ["night"]
    srv = ThreadingHTTPServer(("127.0.0.1", args.port),
                              make_handler(state, theme_holder))
    print(f"viewer: http://127.0.0.1:{args.port}  (scene "
          f"{scene.n_tris} tris, {w}x{h})", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.running = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
