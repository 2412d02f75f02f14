"""Live training viewer: standard-library HTTP server + browser
fly-camera client (counterpart of street_gaussians_ns_tpu/utils/viewer.py).

The reference ships nerfstudio's viser websocket viewer; this is a
dependency-free equivalent with the same contract: a browser page that
flies a camera through the scene while it trains, plus live training
stats. JPEG encoding uses Pillow (utils.optional).

Threading model (the point of the module): HTTP handler threads never
touch a tensor. A `/frame` request parks a render request in a single
slot and blocks on a done-event; the owning thread (the train loop, or
`serve_forever` in the standalone checkpoint viewer, scripts/viewer.py)
calls `service(render_fn)` between steps and renders on its own thread,
so viewer renders serialize with training on one CUDA stream instead of
racing it. `service` is `take` (the parked request, its ladder size
resolved) then `answer` (render, JPEG or 503); a multi-process trainer
calls the two apart, with the ranks' hand-off between them
(parallel/trainer.py). A request nobody takes (the run has ended) is
answered 503 when the client's 60 s wait runs out.

The client keeps the whole camera state (drag = look, wheel = speed,
WASD/QE = move) and posts a raw OpenGL c2w per frame, so the server is
stateless; resolutions are pinned to a fixed ladder.
"""
from __future__ import annotations

import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .optional import pillow_image

# The fixed resolution ladder (width, height).
RES_LADDER = {"low": (480, 270), "med": (960, 540)}

RenderFn = Callable[[np.ndarray, float, int, int], np.ndarray]
#          (c2w (3, 4), time, width, height) -> uint8 (H, W, 3)


_PAGE = """<!DOCTYPE html>
<html><head><title>street-gaussians-ns-tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;overflow:hidden}
#img{position:absolute;top:0;left:0;width:100vw;height:100vh;object-fit:contain}
#hud{position:absolute;top:8px;left:8px;background:#000a;padding:8px 10px;
border-radius:6px;white-space:pre;pointer-events:none}
#help{position:absolute;bottom:8px;left:8px;background:#000a;padding:6px 10px;
border-radius:6px;color:#999}
</style></head><body>
<img id="img"><div id="hud">connecting…</div>
<div id="help">drag: look · wheel: speed · WASD/QE: move · R: reset · H: res</div>
<script>
let yaw=0, pitch=0, pos=[0,0,0], t0=0, speed=0.1, res="low";
let init=null, busy=false, dirty=true, keys={};
const img=document.getElementById('img'), hud=document.getElementById('hud');
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function norm(v){const l=Math.hypot(...v)||1;return v.map(x=>x/l);}
function axes(){
 const f=[Math.cos(pitch)*Math.sin(yaw),Math.cos(pitch)*Math.cos(yaw),
          Math.sin(pitch)];          // forward, world up = +z
 const r=norm(cross(f,[0,0,1])), u=cross(r,f);
 return [r,u,f];}
function c2w(){
 const [r,u,f]=axes();
 return [r[0],u[0],-f[0],pos[0], r[1],u[1],-f[1],pos[1],
         r[2],u[2],-f[2],pos[2]];}
function reset(){
 if(!init)return;
 const m=init.c2w; pos=[m[3],m[7],m[11]];
 const f=[-m[2],-m[6],-m[10]];
 yaw=Math.atan2(f[0],f[1]); pitch=Math.asin(Math.max(-1,Math.min(1,f[2])));
 t0=init.time; dirty=true;}
window.addEventListener('keydown',e=>{keys[e.key.toLowerCase()]=true;
 if(e.key==='r')reset();
 if(e.key==='h'){res=res==='low'?'med':'low';dirty=true;}});
window.addEventListener('keyup',e=>{keys[e.key.toLowerCase()]=false;});
let drag=null;
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('pointerup',()=>{drag=null;});
window.addEventListener('pointermove',e=>{
 if(!drag)return;
 yaw+=(e.clientX-drag[0])*0.004; pitch-=(e.clientY-drag[1])*0.004;
 pitch=Math.max(-1.5,Math.min(1.5,pitch)); drag=[e.clientX,e.clientY];
 dirty=true;});
window.addEventListener('wheel',e=>{speed*=e.deltaY<0?1.3:0.77;});
function step(){
 const [r,u,f]=axes(); let mv=false;
 const add=(v,s)=>{pos=pos.map((p,i)=>p+v[i]*s*speed);mv=true;};
 if(keys['w'])add(f,1); if(keys['s'])add(f,-1);
 if(keys['a'])add(r,-1); if(keys['d'])add(r,1);
 if(keys['q'])add(u,-1); if(keys['e'])add(u,1);
 if(mv)dirty=true;}
async function loop(){
 step();
 if(dirty&&!busy&&init){
  busy=true; dirty=false;
  try{
   const q=new URLSearchParams({c2w:c2w().join(','),time:t0,res:res});
   const resp=await fetch('/frame?'+q);
   if(resp.ok){const b=await resp.blob();
    const old=img.src; img.src=URL.createObjectURL(b);
    if(old)URL.revokeObjectURL(old);}
  }catch(e){}
  busy=false;}
 requestAnimationFrame(loop);}
async function stats(){
 try{const s=await(await fetch('/state')).json();
  hud.textContent=Object.entries(s).map(([k,v])=>
   k.padEnd(16)+(typeof v==='number'?v.toPrecision(5):v)).join('\\n');
 }catch(e){}
 setTimeout(stats,1000);}
fetch('/init').then(r=>r.json()).then(j=>{init=j;reset();loop();stats();});
</script></body></html>"""


class ViewerServer:
    """Single-slot render bridge + HTTP front end (see module docstring).
    The server thread starts in the constructor; `close` stops it."""

    def __init__(self, port: int = 7007, host: str = "0.0.0.0"):
        self._lock = threading.Lock()
        self._req: Optional[dict] = None
        self._resp: Optional[bytes] = None
        self._req_evt = threading.Event()
        self._done_evt = threading.Event()
        self._init: Dict = {}
        self._stats: Dict = {}
        self._stats_lock = threading.Lock()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif u.path == "/init":
                    self._send(200, json.dumps(viewer._init).encode(),
                               "application/json")
                elif u.path == "/state":
                    with viewer._stats_lock:
                        body = json.dumps(viewer._stats).encode()
                    self._send(200, body, "application/json")
                elif u.path == "/frame":
                    q = parse_qs(u.query)
                    try:
                        c2w = np.array(
                            [float(x) for x in q["c2w"][0].split(",")],
                            np.float32).reshape(3, 4)
                        t = float(q.get("time", ["0"])[0])
                        res = q.get("res", ["low"])[0]
                    except (KeyError, ValueError):
                        self._send(400, b"bad params", "text/plain")
                        return
                    data = viewer._request_frame(c2w, t, res)
                    if data is None:
                        self._send(503, b"render failed or timed out",
                                   "text/plain")
                    else:
                        self._send(200, data, "image/jpeg")
                else:
                    self._send(404, b"not found", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- called from HTTP handler threads ---------------------------------
    def _request_frame(self, c2w: np.ndarray, t: float, res: str,
                       timeout: float = 60.0) -> Optional[bytes]:
        with self._lock:                      # one request in flight
            self._done_evt.clear()
            self._req = {"c2w": c2w, "time": t, "res": res}
            self._req_evt.set()
            if not self._done_evt.wait(timeout):
                self._req = None
                self._req_evt.clear()
                return None
            return self._resp

    # -- called from the owning thread ------------------------------------
    def set_init(self, c2w: np.ndarray, time_value: float,
                 extras: Optional[Dict] = None):
        """The browser's initial camera: a (3, 4) OpenGL c2w + scene
        time."""
        self._init = {"c2w": [float(x) for x in np.asarray(c2w).reshape(-1)],
                      "time": float(time_value)}
        if extras:
            self._init.update(extras)

    def update_stats(self, **kw):
        with self._stats_lock:
            self._stats.update(
                {k: (float(v) if isinstance(v, (int, float, np.floating))
                     else v) for k, v in kw.items()})

    def take(self) -> Optional[dict]:
        """Take the parked request out of its slot: {"c2w": (3, 4)
        float32, "time", "res", "width", "height"} with the ladder's size
        resolved (an unknown res is "low"), or None when none waits. The
        client waits until `answer` (or its own timeout)."""
        if not self._req_evt.is_set():
            return None
        req, self._req = self._req, None
        self._req_evt.clear()
        if req is None:
            return None
        req["width"], req["height"] = RES_LADDER.get(req["res"],
                                                     RES_LADDER["low"])
        return req

    def answer(self, req: dict, render_fn: RenderFn) -> None:
        """Render a taken request and answer its client: the JPEG, or a 503
        when render_fn raises (reported, not re-raised: /state carries
        "render_error" and the traceback goes to stderr, so a bad request
        never stops the training loop)."""
        try:
            rgb = render_fn(req["c2w"], req["time"], req["width"],
                            req["height"])
            buf = io.BytesIO()
            pillow_image().fromarray(rgb).save(buf, "JPEG", quality=88)
            self._resp = buf.getvalue()
        except Exception as e:                # the boundary that keeps running
            traceback.print_exc()
            self._resp = None
            self.update_stats(render_error=repr(e))
        self._done_evt.set()

    def service(self, render_fn: RenderFn) -> bool:
        """Render the pending request, if any (take, then answer). Returns
        True if it did."""
        req = self.take()
        if req is None:
            return False
        self.answer(req, render_fn)
        return True

    def serve_forever(self, render_fn: RenderFn, poll_s: float = 0.02):
        """The standalone servicing loop (scripts/viewer.py), until
        ctrl-c."""
        try:
            while True:
                if not self.service(render_fn):
                    time.sleep(poll_s)
        except KeyboardInterrupt:
            pass

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
