"""`ut-viewer` on the card: an interactive web viewer for trained runs.

Counterpart of ``uncertainty_nerf_gs_tpu/scripts/viewer.py``: a stdlib
``http.server`` that renders frames on demand through the same predictive
paths the eval CLI uses (``build_chunk_render_fn`` for the nerfacto family
with MC-dropout and Laplace, ``build_ensemble_chunk_fn`` for a nerfacto
ensemble, ``render_splat`` for a splat run and
``build_ensemble_splat_render_cam`` for a splat ensemble), and the same
self-contained HTML/JS orbit page. Channels: rgb, depth and the method's
uncertainty std map (and an ensemble's epistemic and aleatoric
variances), jet-coloured inside a window frozen at the first render of
each mode. The PNGs come from ``data/png.py`` and the jet table from
``utils/colormaps.py``: the card's machine has neither PIL nor matplotlib.

``LiveViewerState`` serves a trainer while it trains (``scripts/train.py
--viewer-port``): every frame renders from the current parameters. Its
lock is the trainer's ``launch_lock``, held around each training launch,
so a render runs only between launches: it never joins or breaks the
capture of a K-step CUDA graph, and it draws nothing from the trainer's
generator, so a run with the viewer trains bit for bit as one without it.

Usage:
    python -m uncertainty_nerf_gs_torch.scripts.viewer --load-config outputs/run1 [--port 7007]

Then open http://localhost:7007: drag to orbit, wheel to zoom, buttons to
switch rgb/depth/std.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras
from uncertainty_nerf_gs_torch.data.png import png_bytes
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.utils.images import colorize, to_u8

_STD_KEYS = ("rgb_std", "uncertainty")  # nerfacto-family / active-splat


def _orbit_from_cameras(base) -> tuple[list[float], float]:
    """Initial orbit (center, radius) from a camera set: the center is the
    least-squares intersection of the cameras' optical axes (the point they
    look at), not their mean position."""
    c2w = base.camera_to_worlds.detach().cpu().numpy()
    pos = c2w[:, :3, 3]
    fwd = -c2w[:, :3, 2]  # OpenGL -z
    fwd = fwd / np.linalg.norm(fwd, axis=1, keepdims=True)
    # sum_i (I - d_i d_i^T) c = sum_i (I - d_i d_i^T) p_i
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for p, d in zip(pos, fwd):
        M = np.eye(3) - np.outer(d, d)
        A += M
        b += M @ p
    center = np.linalg.lstsq(A, b, rcond=None)[0]
    radius = float(np.linalg.norm(pos - center, axis=1).mean())
    return center.tolist(), radius


def _view_size(base, downscale: int) -> tuple[int, int, float, float, float, float]:
    """(width, height, fx, fy, cx, cy) of the view at ``downscale``."""
    width = max(16, base.width // downscale)
    height = max(16, base.height // downscale)
    fx = float(base.fx[0]) * (width / base.width)
    fy = float(base.fy[0]) * (height / base.height)
    return width, height, fx, fy, width / 2.0, height / 2.0


class ViewerState:
    """Loads a run (or M runs: an eval-time ensemble) and renders arbitrary
    poses through the method's own predictive path, one render at a time
    (``lock``)."""

    def __init__(self, run_dir: Path | list[Path], downscale: int = 4, mc_samples: int = 10,
                 laplace_samples: int = 20, device: str | torch.device | None = None):
        from uncertainty_nerf_gs_torch.interop import stack_params
        from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import (
            _eval_cameras_and_images,
            _load_run,
            build_chunk_render_fn,
            build_ensemble_chunk_fn,
            build_ensemble_splat_render_cam,
        )

        run_dirs = [Path(d) for d in (run_dir if isinstance(run_dir, (list, tuple)) else [run_dir])]
        self.run_dir = run_dirs[0]
        loaded = [_load_run(d, device) for d in run_dirs]
        trainers = [t for t, _, _, _ in loaded]
        self.trainer, self.spec, run_cfg, self.step = loaded[0]
        self.num_members = len(trainers)
        eval_outputs, _ = _eval_cameras_and_images(run_cfg)
        base = eval_outputs.cameras
        self.base_cameras = base
        self.width, self.height, self.fx, self.fy, self.cx, self.cy = _view_size(base, downscale)
        self.lock = threading.Lock()
        self._windows: dict[str, tuple[float, float]] = {}

        self._splat_render_cam = None
        self.chunk_fn = None
        if self.num_members > 1:  # eval-time deep ensemble (M run dirs)
            if self.spec.family == "splatfacto":
                self._splat_render_cam = build_ensemble_splat_render_cam(trainers, self.width, self.height)
            else:
                stacked = stack_params([{k: v.detach() for k, v in t.params().items()} for t in trainers])
                self.chunk_fn = build_ensemble_chunk_fn(self.trainer.model, stacked)
        elif self.spec.family != "splatfacto":
            self.chunk_fn = build_chunk_render_fn(self.trainer, self.spec, mc_samples=mc_samples,
                                                  laplace_samples=laplace_samples, run_dir=self.run_dir)

        self.center, self.radius = _orbit_from_cameras(base)
        probe = self.render_pose(base.camera_to_worlds[0].detach().cpu().numpy().astype(np.float32))
        self.modes = ["rgb"] + (["depth"] if "depth" in probe else []) + [
            k for k in _STD_KEYS if k in probe
        ] + [  # ensemble decomposition: epistemic vs aleatoric variance
            k for k in ("rgb_var_epi", "rgb_var_alea") if k in probe
        ]

    # ---- rendering ------------------------------------------------------
    def _render(self, c2w: torch.Tensor) -> dict[str, torch.Tensor]:
        """One frame's outputs on the device; called under ``lock``."""
        from uncertainty_nerf_gs_torch.models import splatfacto as sf
        from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _nerfacto_full_image_renderer

        if self._splat_render_cam is not None:  # splat ensemble
            return self._splat_render_cam(c2w, self.fx, self.fy, self.cx, self.cy)
        trainer = self.trainer
        if self.spec.family == "splatfacto":
            cfg = trainer.config
            with torch.no_grad():
                out = sf.render_splat(trainer.params, trainer.splat_state.alive, c2w, self.fx, self.fy, self.cx,
                                      self.cy, self.width, self.height, cfg, sh_deg=cfg.sh_degree,
                                      background=sf.fixed_background(cfg, trainer.device))
            return {k: v for k, v in out.items() if k not in ("radii", "visible")}
        one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
        cams = Cameras(camera_to_worlds=c2w[None].cpu(), fx=one(self.fx), fy=one(self.fy), cx=one(self.cx),
                       cy=one(self.cy), width=self.width, height=self.height)
        return _nerfacto_full_image_renderer(trainer.config, self.chunk_fn, cams, trainer.device)(0)

    def render_pose(self, c2w: np.ndarray) -> dict[str, np.ndarray]:
        """Render one frame at an OpenGL (3, 4) camera-to-world pose: the
        outputs as host arrays, every device tensor released before the
        lock is."""
        with self.lock:
            out = self._render(torch.as_tensor(np.asarray(c2w, np.float32), device=self.trainer.device))
            frame = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                     for k, v in out.items()}
            del out
        return frame

    def render_png(self, c2w: np.ndarray, mode: str) -> bytes:
        outs = self.render_pose(c2w)
        if mode not in outs:
            raise KeyError(f"mode {mode!r} not in {sorted(outs)}")
        arr = outs[mode]
        if mode == "rgb":
            img = to_u8(arr)
        else:
            # freeze the colormap window at the first render of each mode
            # (fixed unc_min/unc_max semantics: stable colors across poses)
            win = self._windows.get(mode)
            if win is None:
                x = np.asarray(arr, np.float32)
                x = x.mean(-1) if x.ndim == 3 else x
                win = (float(np.nanmin(x)), float(np.nanmax(x)))
                self._windows[mode] = win
            img = colorize(arr, lo=win[0], hi=win[1])
        return png_bytes(img)

    def info(self) -> dict:
        return {
            "method": self.spec.name,
            "num_members": self.num_members,
            "step": self.step,
            "width": self.width,
            "height": self.height,
            "modes": self.modes,
            "center": self.center,
            "radius": self.radius,
        }


class LiveViewerState(ViewerState):
    """The training-time live viewer over an in-progress trainer: every
    frame renders from the current parameters (the nerfacto family's eval
    forward with the average appearance; a splat trainer's render). Its
    ``lock`` becomes the trainer's ``launch_lock``, so renders and training
    launches take turns; ``rendered_at`` records the trainer's step at each
    render."""

    def __init__(self, trainer, spec, downscale: int = 4):
        self.trainer = trainer
        self.spec = spec
        self.num_members = 1
        self.run_dir = None
        base = trainer.cameras
        self.base_cameras = base
        self.width, self.height, self.fx, self.fy, self.cx, self.cy = _view_size(base, downscale)
        self.lock = threading.Lock()
        trainer.launch_lock = self.lock
        self._windows = {}
        self._splat_render_cam = None
        self.chunk_fn = None
        self.rendered_at: list[int] = []
        if spec.family != "splatfacto":
            def chunk_fn(rb):
                return self.trainer.model(rb, train=False, use_average_appearance=True)

            self.chunk_fn = chunk_fn
        self.center, self.radius = _orbit_from_cameras(base)
        probe = self.render_pose(base.camera_to_worlds[0].detach().cpu().numpy().astype(np.float32))
        self.modes = ["rgb"] + (["depth"] if "depth" in probe else []) + [k for k in _STD_KEYS if k in probe]

    @property
    def step(self) -> int:  # live: info() reports the current train step
        return int(self.trainer.step)

    @step.setter
    def step(self, value):  # ViewerState's constructor assigns; live ignores it
        pass

    def _render(self, c2w: torch.Tensor) -> dict[str, torch.Tensor]:
        self.rendered_at.append(int(self.trainer.step))
        return super()._render(c2w)

    def render_png(self, c2w: np.ndarray, mode: str) -> bytes:
        # the std/depth value range moves during training: re-window every
        # frame instead of freezing at the first render
        self._windows.pop(mode, None)
        return super().render_png(c2w, mode)


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ut-viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
 #bar { padding:6px 10px; background:#1c1c1c; display:flex; gap:8px;
        align-items:center; }
 #bar button { background:#333; color:#ddd; border:1px solid #555;
               padding:3px 10px; cursor:pointer; }
 #bar button.active { background:#2a6; color:#fff; }
 #view { display:block; margin:12px auto; image-rendering:pixelated;
         cursor:grab; border:1px solid #333; }
 #stat { margin-left:auto; opacity:.7 }
</style></head><body>
<div id="bar"><b>ut-viewer</b><span id="modes"></span>
 <span id="stat"></span></div>
<img id="view" draggable="false">
<script>
let info=null, az=0.6, el=0.35, radius=1, center=[0,0,0], mode="rgb";
let busy=false, dirty=false;
function c2w(){
  const ca=Math.cos(az), sa=Math.sin(az), ce=Math.cos(el), se=Math.sin(el);
  const o=[center[0]+radius*ca*ce, center[1]+radius*sa*ce,
           center[2]+radius*se];
  let f=[center[0]-o[0],center[1]-o[1],center[2]-o[2]];
  const nf=Math.hypot(...f); f=f.map(v=>v/nf);
  const r=[f[1], -f[0], 0];  // right = forward x up(z)
  const nr=Math.hypot(...r)||1e-8; const R=r.map(v=>v/nr);
  const u=[R[1]*f[2]-R[2]*f[1], R[2]*f[0]-R[0]*f[2], R[0]*f[1]-R[1]*f[0]];
  return [[R[0],u[0],-f[0],o[0]],[R[1],u[1],-f[1],o[1]],
          [R[2],u[2],-f[2],o[2]]];
}
async function refresh(){
  if(busy){dirty=true;return;} busy=true;
  const t0=performance.now();
  const r=await fetch("/render",{method:"POST",
    headers:{"content-type":"application/json"},
    body:JSON.stringify({c2w:c2w(),mode:mode})});
  const b=await r.blob();
  const v=document.getElementById("view");
  if(v.src) URL.revokeObjectURL(v.src);
  v.src=URL.createObjectURL(b);
  document.getElementById("stat").textContent=
    mode+" · "+((performance.now()-t0)|0)+" ms";
  busy=false; if(dirty){dirty=false; refresh();}
}
async function init(){
  info=await (await fetch("/info")).json();
  center=info.center; radius=info.radius;
  const v=document.getElementById("view");
  v.width=info.width*4; v.height=info.height*4;
  const m=document.getElementById("modes");
  info.modes.forEach(k=>{
    const b=document.createElement("button"); b.textContent=k;
    if(k===mode) b.className="active";
    b.onclick=()=>{mode=k;
      m.querySelectorAll("button").forEach(x=>x.className="");
      b.className="active"; refresh();};
    m.appendChild(b);
  });
  let drag=null;
  v.onmousedown=e=>{drag=[e.clientX,e.clientY]; e.preventDefault();};
  window.onmouseup=()=>{drag=null;};
  window.onmousemove=e=>{
    if(!drag) return;
    az-=(e.clientX-drag[0])*0.01; el+=(e.clientY-drag[1])*0.01;
    el=Math.max(-1.4,Math.min(1.4,el)); drag=[e.clientX,e.clientY];
    refresh();
  };
  v.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001); e.preventDefault();
    refresh();};
  refresh();
}
init();
</script></body></html>
"""


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("content-type", ctype)
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html")
            elif self.path == "/info":
                self._send(200, json.dumps(state.info()).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/render":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("content-length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                c2w = np.asarray(req["c2w"], np.float32).reshape(3, 4)
                png = state.render_png(c2w, req.get("mode", "rgb"))
            except Exception as e:  # a malformed body, pose or mode -> 400, not a dead socket
                self._send(400, str(e).encode(), "text/plain")
                return
            self._send(200, png, "image/png")

    return Handler


def serve(state: ViewerState, host: str = "127.0.0.1", port: int = 7007):
    return ThreadingHTTPServer((host, port), make_handler(state))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="interactive run viewer")
    ap.add_argument("--load-config", action="append", required=True,
                    help="trained run dir (repeat for an eval-time ensemble: combined mean + epi/alea std modes)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--downscale", type=int, default=4, help="render at eval resolution / downscale")
    ap.add_argument("--mc-samples", type=int, default=10)
    ap.add_argument("--laplace-samples", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device to render on; the card by default, 'cpu' for a try without one")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    state = ViewerState([Path(d) for d in args.load_config], downscale=args.downscale,
                        mc_samples=args.mc_samples, laplace_samples=args.laplace_samples, device=device)
    server = serve(state, args.host, args.port)
    print(f"ut-viewer: {state.spec.name} step {state.step} — http://{args.host}:{server.server_address[1]} "
          f"({state.width}x{state.height}, modes {state.modes})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
