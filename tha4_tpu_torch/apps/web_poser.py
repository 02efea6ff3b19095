"""web_poser — interactive manual poser in the browser, on the card
(counterpart of ``tha4_tpu/apps/web_poser.py``, ``tha4-torch-web-poser``).

The original ships wxPython GUIs (full_manual_poser /
character_model_manual_poser); the interactive equivalent here is a
zero-dependency web UI: stdlib http.server serving one HTML page of sliders
(grouped by pose category, with the schema's ranges and defaults) and a PNG
endpoint that renders the posed frame.  The poser runs on ``--device``
(``cuda`` by default, with no fallback); the image goes to the device once,
and the display conversion runs there too.

  tha4-torch-web-poser --model data/character_models/lambda_00/character_model.yaml
  tha4-torch-web-poser --teacher --input char.png        # five-network teacher
  -> open http://localhost:8765
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tha4 poser</title>
<style>
 body { font-family: sans-serif; display: flex; gap: 16px; margin: 12px; background:#fafafa; }
 #panel { width: 360px; max-height: 95vh; overflow-y: auto; }
 .group { margin-bottom: 6px; }
 .cat { font-weight: bold; margin: 10px 0 4px; color: #444; text-transform: lowercase;}
 label { display: inline-block; width: 190px; font-size: 12px; }
 input[type=range] { width: 130px; vertical-align: middle; }
 #frame { image-rendering: auto; border: 1px solid #ccc; background:
   repeating-conic-gradient(#eee 0% 25%, #fff 0% 50%) 0 0/24px 24px; }
 #status { font-size: 12px; color: #666; }
 button { margin: 2px; }
</style></head>
<body>
<div id="panel">
  <div><button onclick="resetPose()">reset</button>
       <select id="outidx"></select>
       <span id="status"></span></div>
  <div id="sliders"></div>
</div>
<img id="frame" width="512" height="512">
<script>
let params = [];
let pending = false, queued = false;
async function init() {
  const meta = await (await fetch('meta')).json();
  params = meta.params;
  const sliders = document.getElementById('sliders');
  let lastCat = null;
  for (const p of params) {
    if (p.category !== lastCat) {
      const d = document.createElement('div');
      d.className = 'cat'; d.textContent = p.category;
      sliders.appendChild(d);
      lastCat = p.category;
    }
    const row = document.createElement('div');
    row.className = 'group';
    row.innerHTML = `<label>${p.name}</label>` +
      `<input type="range" min="${p.min}" max="${p.max}" step="0.01" ` +
      `value="${p.default}" id="s_${p.index}" oninput="render()">`;
    sliders.appendChild(row);
  }
  const sel = document.getElementById('outidx');
  for (let i = 0; i < meta.output_length; i++) {
    const o = document.createElement('option');
    o.value = i; o.textContent = 'output ' + i;
    sel.appendChild(o);
  }
  sel.onchange = render;
  render();
}
function poseVector() {
  return params.map(p => document.getElementById('s_' + p.index).value).join(',');
}
function resetPose() {
  for (const p of params) document.getElementById('s_' + p.index).value = p.default;
  render();
}
async function render() {
  if (pending) { queued = true; return; }
  pending = true;
  const t0 = performance.now();
  const idx = document.getElementById('outidx').value;
  const url = 'pose.png?i=' + idx + '&p=' + poseVector() + '&t=' + Date.now();
  const img = document.getElementById('frame');
  await new Promise(res => { img.onload = res; img.onerror = res; img.src = url; });
  document.getElementById('status').textContent =
      (performance.now() - t0).toFixed(0) + ' ms';
  pending = false;
  if (queued) { queued = false; render(); }
}
init();
</script>
</body></html>
"""


class _PoserState:
    def __init__(self, poser, image, pose_parameters):
        self.poser = poser
        self.image = image
        self.pose_parameters = pose_parameters
        self.lock = threading.Lock()

    def meta(self) -> dict:
        entries = []
        for group in self.pose_parameters.get_pose_parameter_groups():
            lo, hi = group.get_range()
            for k, name in enumerate(group.get_parameter_names()):
                entries.append(
                    {
                        "name": name,
                        "index": group.parameter_index + k,
                        "min": lo,
                        "max": hi,
                        "default": group.get_default_value(),
                        "category": group.get_category().name,
                    }
                )
        return {"params": entries, "output_length": self.poser.get_output_length()}

    def render_png(self, pose, output_index: int) -> bytes:
        """The posed frame as an RGBA PNG: linear -> sRGB, straight alpha,
        truncated to uint8, as the JAX package's render_png; the conversion
        runs where the frame is."""
        import PIL.Image
        import torch

        from tha4_tpu_torch.core import imagecodec

        with self.lock:
            frame = self.poser.pose(self.image, pose, output_index)[0]
        if frame.shape[-1] < 4:
            frame = frame[..., :1].repeat(1, 1, 4)
        display = imagecodec.to_display_rgba(frame)
        rgb = imagecodec.unpremultiply_alpha(display[..., :3], display[..., 3:4])
        out = torch.cat([rgb, display[..., 3:4]], dim=-1)
        pixels = (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        buf = io.BytesIO()
        PIL.Image.fromarray(pixels, "RGBA").save(buf, format="PNG")
        return buf.getvalue()


def _make_handler(state: _PoserState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html")
            elif parsed.path == "/meta":
                self._send(200, json.dumps(state.meta()).encode(), "application/json")
            elif parsed.path == "/pose.png":
                import numpy as np

                try:
                    q = urllib.parse.parse_qs(parsed.query)
                    n = state.pose_parameters.get_parameter_count()
                    pose = state.pose_parameters.get_default_pose()
                    if "p" in q:
                        vals = [float(v) for v in q["p"][0].split(",")][:n]
                        pose[: len(vals)] = np.asarray(vals, np.float32)
                    idx = int(q.get("i", ["0"])[0])
                    if not 0 <= idx < state.poser.get_output_length():
                        raise ValueError(f"output index {idx} out of range")
                except (ValueError, IndexError) as e:
                    self._send(400, f"bad request: {e}".encode(), "text/plain")
                    return
                try:
                    png = state.render_png(pose, idx)
                except Exception as e:  # surface render errors to the client
                    self._send(500, str(e).encode(), "text/plain")
                    return
                self._send(200, png, "image/png")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default=None, help="character_model.yaml (student mode)")
    parser.add_argument("--teacher", action="store_true", help="use the five-network teacher")
    parser.add_argument("--input", default=None, help="512x512 RGBA image (teacher mode)")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default loopback; set e.g. 0.0.0.0 to expose on the LAN)")
    parser.add_argument(
        "--dtype", choices=("f32", "bf16", "exact"), default="f32",
        help="compute path: f32 and exact are the same here, float32 with full-f32 products "
        "(no TF32) [default]; bf16 = the fastest")
    parser.add_argument("--bf16", action="store_true", help=argparse.SUPPRESS)  # legacy alias
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    args = parser.parse_args(argv)

    import torch

    mode = "bf16" if args.bf16 else args.dtype
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32

    if args.teacher:
        if not args.input:
            parser.error("--teacher requires --input")
        from tha4_tpu_torch.core import imagecodec
        from tha4_tpu_torch.poser.modes import mode_07

        poser = mode_07.create_poser(compute_dtype=dtype, device=args.device)
        image = imagecodec.load_image_hwc(args.input)
    else:
        if not args.model:
            parser.error("--model is required (or use --teacher --input)")
        from tha4_tpu_torch.charmodel import CharacterModel

        model = CharacterModel.load(args.model)
        poser = model.get_poser(dtype, args.device)
        image = model.get_character_image()
    # One tensor on the device for every request: the teacher's prologue
    # (the eyebrow decomposer) is cached per image object.
    image = torch.from_numpy(image).to(args.device)

    state = _PoserState(poser, image, poser.pose_parameters)
    print("warming up...")
    state.render_png(state.pose_parameters.get_default_pose(), 0)
    server = ThreadingHTTPServer((args.host, args.port), _make_handler(state))
    print(f"tha4 web poser on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
