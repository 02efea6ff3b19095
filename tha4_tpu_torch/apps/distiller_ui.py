"""distiller_ui — create/edit a distillation config, then optionally train
on the card (counterpart of ``tha4_tpu/apps/distiller_ui.py``,
``tha4-torch-distill-config``).

Headless equivalent of the reference wx config editor
(reference: src/tha4/app/distiller_ui.py + src/tha4/distiller/ui/): every
parameter the UI exposes is a flag; --interactive prompts for missing values;
--train runs the distillation after writing the config (the reference's
RUN button exits the UI then runs run_config in-process,
reference distiller_ui.py:10-13).  Training runs on the card unless
``--device cpu`` is given.

``--web`` serves the same editor as a browser form: one page with every
DistillerConfig field, per-field help from the same corpus as ``--explain``
(the reference's distiller-ui-doc/params/*.html), seed Randomize buttons
(reference distiller_ui_main_frame.py:359-473), validate-and-save, and a RUN
button that starts the distillation in-process and streams status.
Loopback-bound by default.

Examples:
  tha4-torch-distill-config --prefix jobs/lambda --character char.png --mask mask.png --train
  tha4-torch-distill-config --web               # open http://localhost:8766
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_FORM_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tha4 distiller config</title>
<style>
 body { font-family: sans-serif; max-width: 760px; margin: 16px auto; background:#fafafa; }
 .field { margin: 8px 0; }
 label { display: inline-block; width: 340px; font-size: 13px; vertical-align: top; }
 input, select { width: 280px; font-size: 13px; }
 .help { color: #777; font-size: 11px; margin: 2px 0 0 344px; max-width: 380px;
         white-space: pre-wrap; display: none; }
 .field:hover .help { display: block; }
 button { margin: 8px 6px 0 0; padding: 6px 14px; }
 #status { margin-top: 10px; font-size: 13px; white-space: pre-wrap; }
 .err { color: #b00; } .ok { color: #070; }
 .rand { width: auto; font-size: 11px; }
</style></head>
<body>
<h2>tha4 distiller config</h2>
<form id="form"></form>
<button onclick="save()">Validate &amp; save</button>
<button onclick="run()">RUN</button>
<div id="status"></div>
<script>
// Per-launch CSRF token, injected by the server into this page only: POSTs
// carry it in a custom header (which also forces a CORS preflight that a
// cross-origin page cannot pass), so a malicious web page visited while the
// editor runs cannot drive /save or /train on the loopback server.
const TOKEN = '%TOKEN%';
let meta = null;
async function init() {
  meta = await (await fetch('meta')).json();
  const form = document.getElementById('form');
  for (const f of meta.fields) {
    const d = document.createElement('div'); d.className = 'field';
    const l = document.createElement('label'); l.textContent = f.name; d.appendChild(l);
    let inp;
    if (f.choices) {
      inp = document.createElement('select');
      for (const c of f.choices) {
        const o = document.createElement('option');
        o.value = c === null ? 'null' : String(c);
        o.textContent = c === null ? 'null (disable)' : String(c);
        inp.appendChild(o);
      }
      inp.value = f.value === null ? 'null' : String(f.value);
    } else {
      inp = document.createElement('input');
      inp.value = f.value === null ? '' : String(f.value);
    }
    inp.id = 'f_' + f.name; d.appendChild(inp);
    if (f.seed) {
      const b = document.createElement('button');
      b.type = 'button'; b.className = 'rand'; b.textContent = 'Randomize';
      b.onclick = () => {
        const hi = BigInt(Math.floor(Math.random() * 4294967296));
        const lo = BigInt(Math.floor(Math.random() * 4294967296));
        inp.value = ((hi << 32n) | lo).toString();
      };
      d.appendChild(b);
    }
    const h = document.createElement('div'); h.className = 'help';
    h.textContent = f.help || ''; d.appendChild(h);
    form.appendChild(d);
  }
  poll();
}
function values() {
  const out = {};
  for (const f of meta.fields) {
    const v = document.getElementById('f_' + f.name).value;
    out[f.name] = v === 'null' ? null : v;
  }
  return out;
}
async function save() {
  const r = await fetch('save', {method: 'POST', body: JSON.stringify(values()),
                                 headers: {'X-Tha4-Token': TOKEN}});
  const j = await r.json();
  const s = document.getElementById('status');
  s.className = r.ok ? 'ok' : 'err';
  s.textContent = r.ok ? ('saved ' + j.path) : ('error: ' + j.error);
}
async function run() {
  const r = await fetch('train', {method: 'POST', body: JSON.stringify(values()),
                                  headers: {'X-Tha4-Token': TOKEN}});
  const j = await r.json();
  const s = document.getElementById('status');
  s.className = r.ok ? 'ok' : 'err';
  s.textContent = r.ok ? 'training started' : ('error: ' + j.error);
}
async function poll() {
  try {
    const j = await (await fetch('state')).json();
    if (j.running || j.done || j.error) {
      const s = document.getElementById('status');
      s.className = j.error ? 'err' : 'ok';
      s.textContent = j.error ? ('training error: ' + j.error)
        : (j.done ? 'training DONE: ' + j.prefix : 'training running: ' + j.prefix);
    }
  } catch (e) {}
  setTimeout(poll, 2000);
}
init();
</script></body></html>
"""

_INT_FIELDS = (
    "face_morpher_random_seed_0", "face_morpher_random_seed_1", "face_morpher_batch_size",
    "body_morpher_random_seed_0", "body_morpher_random_seed_1", "body_morpher_batch_size",
    "num_cpu_workers", "num_gpus",
)
_SEED_FIELDS = tuple(f for f in _INT_FIELDS if "seed" in f)
_CADENCE_FIELDS = (
    "face_morpher_num_training_examples_per_sample_output",
    "body_morpher_num_training_examples_per_sample_output",
)


def _config_from_values(values: dict):
    """Build + validate a DistillerConfig from the web form's string values.

    Raises ValueError with a user-facing message on any bad field (the wx
    editor surfaces DistillerConfig.check()'s message the same way)."""
    from tha4_tpu_torch.distiller.config import DistillerConfig

    kwargs = {}
    for name in ("prefix", "character_image_file_name", "face_mask_image_file_name"):
        v = (values.get(name) or "").strip()
        if not v:
            raise ValueError(f"{name} is required")
        kwargs[name] = v
    for name in _INT_FIELDS:
        if values.get(name) in (None, ""):
            continue
        try:
            kwargs[name] = int(str(values[name]))
        except ValueError:
            raise ValueError(f"{name} must be an integer, got {values[name]!r}")
    for name in _CADENCE_FIELDS:
        if name not in values:
            continue  # absent -> dataclass default (10,000), not "disabled"
        v = values[name]
        if v is None or v == "null":
            kwargs[name] = None
        else:
            try:
                kwargs[name] = int(str(v))
            except ValueError:
                raise ValueError(f"{name} must be an integer or null, got {v!r}")
    config = DistillerConfig(**kwargs)
    os.makedirs(config.prefix, exist_ok=True)
    config.check()  # raises ValueError with the field's message
    return config


class _TrainState:
    """One training run at a time, in-process (reference RUN semantics)."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.lock = threading.Lock()
        self.thread = None
        self.prefix = None
        self.done = False
        self.error = None

    def start(self, config) -> None:
        from tha4_tpu_torch.distiller.pipeline import run_config

        with self.lock:
            if self.thread is not None and self.thread.is_alive():
                raise ValueError(f"a training run is already active ({self.prefix})")
            self.prefix, self.done, self.error = config.prefix, False, None

            def work():
                try:
                    run_config(config, device=self.device)
                    self.done = True
                except Exception as e:  # surfaced via /state
                    self.error = f"{type(e).__name__}: {e}"

            self.thread = threading.Thread(target=work, daemon=True)
            self.thread.start()

    def snapshot(self) -> dict:
        running = self.thread is not None and self.thread.is_alive()
        return {"running": running, "done": self.done, "error": self.error,
                "prefix": self.prefix}


def _field_meta(config) -> dict:
    """Form metadata; ``config=None`` serves dataclass defaults (required
    path fields blank), matching the wx editor's fresh-start state."""
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.param_help import PARAM_HELP

    fields = []
    for f in dataclasses.fields(DistillerConfig):
        if config is not None:
            value = getattr(config, f.name)
        elif f.default is not dataclasses.MISSING:
            value = f.default
        else:
            value = ""
        # 64-bit seeds exceed JS Number precision (2^53): send them as
        # strings so an untouched form round-trips the exact default instead
        # of the browser's rounded double (the server already int()s every
        # integer field on the way back in).
        if isinstance(value, int) and not isinstance(value, bool) and abs(value) > 2**53:
            value = str(value)
        entry = {
            "name": f.name,
            "value": value,
            "help": PARAM_HELP.get(f.name, ""),
            "seed": f.name in _SEED_FIELDS,
        }
        if f.name in _CADENCE_FIELDS:
            entry["choices"] = [10_000, 100_000, 1_000_000, None]
        fields.append(entry)
    return {"fields": fields}


def _make_web_server(port: int, host: str = "127.0.0.1", initial_config=None, device: str = "cuda"):
    """(server, train_state) for the web editor; caller serves forever."""
    import secrets

    train_state = _TrainState(device)
    meta = _field_meta(initial_config)
    # CSRF defense: POST endpoints write files and launch training, and a
    # cross-origin JSON POST is a no-preflight "simple" request — loopback
    # binding alone does not stop a malicious page in the user's browser.
    # Require a per-launch token (embedded only in our own served page) in a
    # custom header, and reject Origins other than our own.
    token = secrets.token_hex(16)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _post_allowed(self) -> bool:
            origin = self.headers.get("Origin")
            if origin:
                try:
                    ohost = urllib.parse.urlparse(origin).netloc
                except ValueError:
                    return False
                if ohost != self.headers.get("Host", ""):
                    return False
            return secrets.compare_digest(
                self.headers.get("X-Tha4-Token", ""), token)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path in ("/", "/index.html"):
                self._send(200, _FORM_PAGE.replace("%TOKEN%", token).encode(), "text/html")
            elif path == "/meta":
                self._send(200, json.dumps(meta).encode())
            elif path == "/state":
                self._send(200, json.dumps(train_state.snapshot()).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            if not self._post_allowed():
                self._send(403, json.dumps(
                    {"error": "cross-origin or tokenless POST rejected"}).encode())
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                values = json.loads(self.rfile.read(n) or b"{}")
                if path == "/save":
                    config = _config_from_values(values)
                    config.save(config.config_yaml_file_name())
                    self._send(200, json.dumps(
                        {"ok": True, "path": config.config_yaml_file_name()}).encode())
                elif path == "/train":
                    config = _config_from_values(values)
                    config.save(config.config_yaml_file_name())
                    train_state.start(config)
                    self._send(200, json.dumps(
                        {"ok": True, "prefix": config.prefix}).encode())
                else:
                    self._send(404, b'{"error": "not found"}')
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
            except OSError as e:
                # e.g. read-only prefix after makedirs, disk full: return a
                # parseable JSON error instead of dropping the connection.
                self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())

    return ThreadingHTTPServer((host, port), Handler), train_state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--prefix", help="working directory for the distillation job")
    parser.add_argument("--character", help="512x512 RGBA character PNG")
    parser.add_argument("--mask", help="512x512 RGB 0/255 face mask PNG")
    parser.add_argument("--load", help="start from an existing config.yaml")
    parser.add_argument("--face-seed-0", type=int, default=None)
    parser.add_argument("--face-seed-1", type=int, default=None)
    parser.add_argument("--face-batch-size", type=int, default=None)
    parser.add_argument("--face-sample-cadence", type=int, default=None, choices=[10_000, 100_000, 1_000_000])
    parser.add_argument("--body-seed-0", type=int, default=None)
    parser.add_argument("--body-seed-1", type=int, default=None)
    parser.add_argument("--body-batch-size", type=int, default=None)
    parser.add_argument("--body-sample-cadence", type=int, default=None, choices=[10_000, 100_000, 1_000_000])
    parser.add_argument("--num-cpu-workers", type=int, default=None)
    parser.add_argument("--num-chips", type=int, default=None,
                        help="data-parallel GPUs (the config's num_gpus; the JAX package's flag)")
    parser.add_argument("--interactive", action="store_true", help="prompt for missing values")
    parser.add_argument("--train", action="store_true", help="run distillation after saving the config")
    parser.add_argument("--web", action="store_true",
                        help="serve the config editor as a browser form (wx-editor equivalent)")
    parser.add_argument("--port", type=int, default=8766, help="--web port")
    parser.add_argument("--host", default="127.0.0.1",
                        help="--web bind address (loopback by default; 0.0.0.0 exposes it)")
    parser.add_argument("--device", default="cuda", help="where --train and RUN train: cuda (the default) or cpu")
    parser.add_argument("--explain", metavar="PARAM", default=None,
                        help="print detailed documentation for a config parameter (or 'all') and exit — the reference's in-app HTML help corpus")
    args = parser.parse_args(argv)

    if args.explain is not None:
        from tha4_tpu_torch.distiller.param_help import explain

        try:
            print(explain(args.explain))
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2
        return 0

    from tha4_tpu_torch.distiller.config import DistillerConfig

    if args.web:
        initial = DistillerConfig.load(args.load) if args.load else None
        server, _ = _make_web_server(args.port, args.host, initial, args.device)
        print(f"tha4 distiller config editor on http://{args.host}:{server.server_address[1]}")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    def ask(prompt, current):
        if not args.interactive:
            return current
        reply = input(f"{prompt} [{current}]: ").strip()
        return reply or current

    if args.load:
        config = DistillerConfig.load(args.load)
    else:
        prefix = args.prefix or ask("Working directory (prefix)", "")
        character = args.character or ask("Character image PNG", "")
        mask = args.mask or ask("Face mask PNG", "")
        if not (prefix and character and mask):
            parser.error("--prefix, --character and --mask are required (or use --interactive/--load)")
        os.makedirs(prefix, exist_ok=True)
        config = DistillerConfig(
            prefix=prefix,
            character_image_file_name=character,
            face_mask_image_file_name=mask,
        )

    overrides = {
        "face_morpher_random_seed_0": args.face_seed_0,
        "face_morpher_random_seed_1": args.face_seed_1,
        "face_morpher_batch_size": args.face_batch_size,
        "face_morpher_num_training_examples_per_sample_output": args.face_sample_cadence,
        "body_morpher_random_seed_0": args.body_seed_0,
        "body_morpher_random_seed_1": args.body_seed_1,
        "body_morpher_batch_size": args.body_batch_size,
        "body_morpher_num_training_examples_per_sample_output": args.body_sample_cadence,
        "num_cpu_workers": args.num_cpu_workers,
        "num_gpus": args.num_chips,
    }
    config = dataclasses.replace(config, **{k: v for k, v in overrides.items() if v is not None})

    config.check()
    config.save(config.config_yaml_file_name())
    print(f"Wrote {config.config_yaml_file_name()}")

    if args.train:
        from tha4_tpu_torch.distiller.pipeline import run_config

        run_config(config, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
