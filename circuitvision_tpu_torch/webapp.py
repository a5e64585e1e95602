"""Zero-dependency web UI of the PyTorch port (the reference Streamlit app).

    python -m circuitvision_tpu_torch.cli serve --port 8501 \
        --yolo-checkpoint ckpt/yolo --sam2-checkpoint ckpt/sam2

Counterpart of the JAX package's `webapp.py`: the page, `/`, `/device`,
`/analyze` (PNG or JPEG bytes), `/final`, `/mode` and `/simulate`, with
the same JSON field for field. Image upload runs the analysis; results
render in four tabs (Components, Segmentation, Netlist, SPICE); the
netlist is editable; "Get Final Netlist" runs the VLM value pass; "Run
SPICE Analysis" detects DC or AC (app.py:839-874).

Differences from the JAX package:
  * images in the JSON are PNGs encoded here with stdlib zlib (`png_bytes`):
    they decode to the pixels PIL's encoding would, the bytes differ;
  * the debug images are drawn without cv2 (core/viz.py), byte-equal to
    the JAX package's;
  * `/device` reports the device the analyzer runs on, from torch;
  * the phasor plot is not ported (ROADMAP Queue A 7: it needs
    matplotlib's axes), so `/simulate` sends `phasors: ""`, as the JAX
    webapp does where matplotlib is absent;
  * requests that touch the analyzer run one at a time under one lock,
    on the analyzer's device; a CUDA error answers 500 with its text and
    the next request runs on the card again, never on the CPU.

Built on stdlib http.server; all analysis goes through
CircuitAnalyzerTorch.
"""
from __future__ import annotations

import argparse
import base64
import html
import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_STATE: dict = {"analyzer": None, "result": None, "lock": threading.Lock()}


def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an (H, W, 3) or (H, W) uint8 array (grey
    copied to three channels, as the JAX webapp sends it), filter 0 on
    every row, zlib at level 1: a response carries up to ten images, and
    level 6 took ~2x the time for files ~1.7x smaller on the eval set."""
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = np.ascontiguousarray(arr.astype(np.uint8))
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def _png_b64(arr) -> str:
    if arr is None:
        return ""
    return base64.b64encode(png_bytes(np.asarray(arr))).decode()


_PAGE = """<!doctype html><html><head><title>CircuitVision</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#0f1116;color:#e8e8e8}
header{padding:14px 24px;background:#161a23;border-bottom:1px solid #2a2f3a}
h1{font-size:20px;margin:0}
main{padding:20px 24px;max-width:1100px;margin:auto}
.tabs{display:flex;gap:6px;margin:16px 0 0}
.tabs button{background:#1d2330;color:#cfd3dc;border:1px solid #2a2f3a;border-bottom:none;
 padding:8px 18px;border-radius:8px 8px 0 0;cursor:pointer}
.tabs button.active{background:#2a3347;color:#fff}
.panel{border:1px solid #2a2f3a;background:#161a23;padding:18px;border-radius:0 8px 8px 8px}
img.result{max-width:100%;border:1px solid #2a2f3a;border-radius:6px}
textarea{width:100%;min-height:160px;background:#0f1116;color:#d7e3ff;border:1px solid #2a2f3a;
 font-family:ui-monospace,monospace;padding:10px;border-radius:6px}
table{border-collapse:collapse;margin:8px 0}
td,th{border:1px solid #2a2f3a;padding:5px 12px;font-size:13px}
button.action{background:#3b82f6;border:none;color:#fff;padding:8px 16px;border-radius:6px;cursor:pointer;margin:6px 4px 0 0}
pre{background:#0f1116;padding:10px;border-radius:6px;overflow-x:auto}
.badge{display:inline-block;background:#233047;border-radius:20px;padding:3px 12px;font-size:12px;margin-left:8px}
</style></head><body>
<header><h1>CircuitVision <span class="badge">PyTorch · CUDA</span>
<span class="badge" id="dev"></span></h1></header>
<main>
<input type="file" id="file" accept="image/*">
<span id="status"></span>
<div class="tabs">
<button onclick="tab(0)" class="active">🔍 Components</button>
<button onclick="tab(1)">🧩 Segmentation</button>
<button onclick="tab(2)">📝 Netlist</button>
<button onclick="tab(3)">⚡ SPICE</button>
</div>
<div class="panel" id="p0">Upload a circuit image to begin.</div>
<div class="panel" id="p1" style="display:none"></div>
<div class="panel" id="p2" style="display:none"></div>
<div class="panel" id="p3" style="display:none"></div>
</main>
<script>
let R=null;
fetch('/device').then(r=>r.json()).then(j=>{document.getElementById('dev').textContent=j.device;});
function tab(i){for(let j=0;j<4;j++){document.getElementById('p'+j).style.display=i==j?'block':'none';
 document.querySelectorAll('.tabs button')[j].classList.toggle('active',i==j);}}
document.getElementById('file').onchange=async e=>{
 const f=e.target.files[0]; if(!f)return;
 document.getElementById('status').textContent=' analyzing…';
 const r=await fetch('/analyze',{method:'POST',body:await f.arrayBuffer()});
 const j=await r.json();
 if(!r.ok||j.error){document.getElementById('status').textContent=' failed: '+(j.error||r.status);return;}
 R=j; document.getElementById('status').textContent=' done in '+R.total_time.toFixed(1)+'s';
 render();};
function render(){
 let t='<h3>Detections ('+R.bboxes.length+')</h3>';
 if(R.annotated) t+='<img class="result" src="data:image/png;base64,'+R.annotated+'"><br>';
 t+='<table><tr><th>class</th><th>conf</th><th>box</th></tr>'+R.bboxes.map(b=>
  '<tr><td>'+b.class+'</td><td>'+b.confidence.toFixed(2)+'</td><td>['+b.xmin+','+b.ymin+','+b.xmax+','+b.ymax+']</td></tr>').join('')+'</table>';
 if(R.vlm_crops&&R.vlm_crops.length){t+='<h3>Source directions (VLM inputs)</h3>';
  t+=R.vlm_crops.map(c=>'<div style="display:inline-block;margin:4px;text-align:center">'+
   '<img width="100" src="data:image/png;base64,'+c.img+'"><br><small>'+c.class+
   ' <code>'+c.direction+'</code>;<code>'+c.reason+'</code>\u2192<code>'+c.interpreted+'</code></small></div>').join('');}
 if(R.annotated_orig) t+='<h3>Debug: initial YOLO detections on original image</h3><img class="result" src="data:image/png;base64,'+R.annotated_orig+'">';
 t+='<h3>Timings</h3><table>'+Object.entries(R.timings).map(([k,v])=>
  '<tr><td>'+k+'</td><td>'+(v*1000).toFixed(1)+' ms</td></tr>').join('')+'</table>';
 document.getElementById('p0').innerHTML=t;
 let s='<h3>Wire mask</h3>';
 if(R.mask) s+='<img class="result" src="data:image/png;base64,'+R.mask+'">';
 if(R.emptied) s+='<h3>Emptied mask</h3><img class="result" src="data:image/png;base64,'+R.emptied+'">';
 if(R.enhanced) s+='<h3>Enhanced (analysis space)</h3><img class="result" src="data:image/png;base64,'+R.enhanced+'">';
 if(R.node_viz) s+='<h3>Nodes</h3><img class="result" src="data:image/png;base64,'+R.node_viz+'">';
 if(R.contour_viz) s+='<h3>Wire contours</h3><img class="result" src="data:image/png;base64,'+R.contour_viz+'">';
 if(R.connection_viz) s+='<h3>Connection points</h3><img class="result" src="data:image/png;base64,'+R.connection_viz+'">';
 if(R.crop){s+='<h3>Cropping details</h3>';
  s+=R.crop.applied?'<div>\u2705 Cropping applied.</div>':'<div>\u26a0\ufe0f Cropping NOT applied. Reason: '+(R.crop.reason||'Unknown')+'</div>';
  s+='<div>Dimensions (WxH): <code>'+JSON.stringify(R.crop.original_dims)+'</code> \u2192 <code>'+JSON.stringify(R.crop.cropped_dims)+'</code></div>';
  s+='<div>Basis bbox: <code>'+JSON.stringify(R.crop.basis_bbox)+'</code>, clusters: '+R.crop.clusters+', threshold: '+R.crop.clustering_threshold+', source: '+R.crop.source+'</div>';
  s+=(R.crop.text_expansions&&R.crop.text_expansions.length)?'<div>Text-based expansion: '+R.crop.text_expansions.length+' region(s)</div>':'<div>Text-based expansion: none</div>';
  s+='<div>Final crop window: <code>'+JSON.stringify(R.crop.window)+'</code></div>';}
 document.getElementById('p1').innerHTML=s||'No mask.';
 let n='<h3>Netlist ('+R.nodes+' nodes)</h3><textarea id="net">'+R.netlist_text+'</textarea>';
 n+='<br><button class="action" onclick="finalNetlist()">Get Final Netlist (VLM)</button>';
 if(R.netlist_no_dir) n+='<h4>Without VLM directions (comparison)</h4><pre>'+R.netlist_no_dir+'</pre>';
 if(R.enum_img) n+='<h4>Enumerated image (VLM input)</h4><img class="result" src="data:image/png;base64,'+R.enum_img+'">';
 document.getElementById('p2').innerHTML=n;
 let p='<h3>SPICE analysis</h3><div>Mode: <b id="mode">?</b>'+
  ' <label>AC frequency (Hz): <input id="freq" type="number" value="60" step="100"></label></div>'+
  '<button class="action" onclick="runSpice()">Run SPICE Analysis</button><div id="simout"></div>';
 document.getElementById('p3').innerHTML=p; updateMode();}
async function updateMode(){const net=document.getElementById('net').value;
 const r=await fetch('/mode',{method:'POST',body:net}); const j=await r.json();
 document.getElementById('mode').textContent=j.mode;}
async function finalNetlist(){
 const r=await fetch('/final',{method:'POST'}); const j=await r.json();
 if(!r.ok||j.error){document.getElementById('status').textContent=' final netlist failed: '+(j.error||r.status);return;}
 document.getElementById('net').value=j.netlist_text;
 if(j.vlm_raw){let d=document.getElementById('vlmraw');
  if(!d){d=document.createElement('div');d.id='vlmraw';
   document.getElementById('p2').appendChild(d);}
  d.innerHTML='<h4>VLM analysis output (raw)</h4><pre>'+j.vlm_raw+'</pre>';}
 updateMode();}
async function runSpice(){
 const net=document.getElementById('net').value;
 const f=document.getElementById('freq').value;
 const r=await fetch('/simulate?freq='+f,{method:'POST',body:net});
 const j=await r.json();
 document.getElementById('simout').innerHTML= j.ok ?
  '<h4>Node voltages</h4><pre>'+JSON.stringify(j.node_voltages,null,2)+'</pre>'+
  '<h4>Branch currents</h4><pre>'+JSON.stringify(j.branch_currents,null,2)+'</pre>'+
  (j.phasors?'<h4>Phasor diagram</h4><img class="result" src="data:image/png;base64,'+j.phasors+'">':'')
  : '<pre style="color:#f87171">'+j.error+'</pre>';}
</script></body></html>"""



def _format_vlm_output(vlm_out) -> str:
    """The reference's raw-VLM display formatting (app.py:780-789):
    python-ish list-of-dicts text, every key/value single-quoted,
    HTML-escaped (the page injects it via innerHTML inside a <pre>, and
    the text comes from a model's reply; quote=False keeps the quotes of
    the reference's displayed text)."""
    if not vlm_out:
        return ""
    try:
        out = "[\n"
        for comp in vlm_out:
            out += "    {\n"
            for key, value in comp.items():
                out += f"        '{key}': '{value}',\n"
            out = out.rstrip(",\n") + "\n    },\n"
        return html.escape(out.rstrip(",\n") + "\n]", quote=False)
    except Exception:
        # a malformed-but-parseable stage-2 row (non-dict entry) must not
        # 500 the endpoint — show the repr instead
        return html.escape(repr(vlm_out), quote=False)


def _vlm_direction_gallery(result) -> list:
    """Per-component VLM direction crops + interpreted type — the
    reference's "Debug: Source Directions" expander (app.py:643-683).
    Direction and reason are raw model text; the page renders them via
    innerHTML, so they are escaped here."""
    from .core import taxonomy

    out = []
    for b in result.bboxes:
        uid = b.persistent_uid
        if not uid or uid not in result.vlm_direction_crops or b.semantic_direction is None:
            continue
        interpreted = b.class_name
        if b.class_name in taxonomy.VOLTAGE_CLASSES and b.semantic_reason == "ARROW":
            interpreted = "current.ac" if ".ac" in b.class_name else "current.dc"
        elif b.class_name in taxonomy.CURRENT_SOURCE_CLASSES and b.semantic_reason == "SIGN":
            interpreted = "voltage.ac" if ".ac" in b.class_name else "voltage.dc"
        out.append({
            "uid": uid,
            "class": html.escape(b.class_name, quote=False),
            "direction": html.escape(str(b.semantic_direction), quote=False),
            "reason": html.escape(str(b.semantic_reason), quote=False),
            "interpreted": html.escape(interpreted, quote=False),
            "img": _png_b64(result.vlm_direction_crops[uid]),
        })
    return out


def _crop_json(info):
    if not info:
        return None
    return {"applied": info.applied, "window": info.window, "reason": info.reason_for_no_crop,
            "clusters": info.num_clusters, "source": info.decision_source,
            "original_dims": info.original_dims, "cropped_dims": info.cropped_dims,
            "basis_bbox": info.basis_bbox, "clustering_threshold": info.clustering_threshold,
            "text_expansions": info.text_expansions}


def analysis_json(result, image: np.ndarray) -> dict:
    """The `/analyze` response for one AnalysisResult (JAX webapp.py
    field for field)."""
    from .core.viz import create_annotated_image

    analysis_image = result.image_for_analysis if result.image_for_analysis is not None \
        else image
    original = result.original_image if result.original_image is not None else image
    return {
        "bboxes": [b.to_dict() for b in result.bboxes_orig_nms],
        "netlist_text": result.netlist_text or "",
        "netlist_no_dir": result.valueless_netlist_text_no_vlm_dir,
        "nodes": len(result.nodes),
        "timings": result.timings.timings,
        "total_time": result.timings.total(),
        "mask": _png_b64(result.sam_mask),
        "emptied": _png_b64(result.node_mask),
        "enhanced": _png_b64(result.enhanced_mask),
        "node_viz": _png_b64(result.node_visualization),
        "contour_viz": _png_b64(result.contour_visualization),
        "connection_viz": _png_b64(result.connection_points_visualization),
        "crop": _crop_json(result.crop_info),
        "vlm_crops": _vlm_direction_gallery(result),
        "enum_img": _png_b64(result.enum_image),
        "annotated": _png_b64(create_annotated_image(analysis_image, result.bboxes)),
        # "Debug: Original Image" expander (app.py:626-640): NMS'd
        # detections drawn on the original image, before any cropping
        "annotated_orig": _png_b64(create_annotated_image(original, result.bboxes_orig_nms)),
    }


def device_label(analyzer) -> str:
    """The device badge: the analyzer's device type and how many of them
    torch sees, with the card's name."""
    import torch

    dev = analyzer.device
    if dev.type == "cuda":
        return f"CUDA ×{torch.cuda.device_count()} ({torch.cuda.get_device_name(dev)})"
    return f"{dev.type.upper()} ×1"


class Handler(BaseHTTPRequestHandler):
    def _json(self, obj, code=200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/":
            data = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/device":
            self._json({"device": device_label(_STATE["analyzer"])})
        else:
            self.send_error(404)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def do_POST(self):
        from .io.image_io import decode_image
        from .netlist.values import detect_analysis_mode

        try:
            if self.path == "/analyze":
                image = decode_image(self._body())
                with _STATE["lock"]:
                    result = _STATE["analyzer"].analyze(image)
                    _STATE["result"] = result
                    payload = analysis_json(result, image)
                self._json(payload)
            elif self.path == "/final":
                with _STATE["lock"]:
                    result = _STATE["result"]
                    if result is None:
                        return self._json({"error": "no analysis yet"}, 400)
                    result = _STATE["analyzer"].generate_final_netlist(result)
                    _STATE["result"] = result
                # "Debug: VLM" expander's raw-output block (app.py:777-791)
                self._json({"netlist_text": result.netlist_text,
                            "vlm_raw": _format_vlm_output(result.vlm_stage2_output)})
            elif self.path == "/mode":
                self._json({"mode": detect_analysis_mode(self._body().decode())})
            elif self.path.startswith("/simulate"):
                from urllib.parse import parse_qs, urlparse

                freq = float(parse_qs(urlparse(self.path).query).get("freq", ["60"])[0])
                text = self._body().decode()
                with _STATE["lock"]:
                    sim = _STATE["analyzer"].simulate(text, frequency_hz=freq)
                self._json({"ok": sim.ok, "node_voltages": sim.node_voltages,
                            "branch_currents": sim.branch_currents, "error": sim.error,
                            "phasors": ""})
            else:
                self.send_error(404)
        except Exception as e:  # surface errors to the UI, CUDA ones included
            self._json({"ok": False, "error": str(e)}, 500)

    def log_message(self, *args):
        pass


def make_server(analyzer, port: int = 8501, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The web UI's server for `analyzer` (not started); port 0 binds an
    ephemeral port (`server.server_address[1]`)."""
    _STATE["analyzer"], _STATE["result"] = analyzer, None
    return ThreadingHTTPServer((host, port), Handler)


def serve(analyzer, port: int = 8501) -> None:
    """Serve the web UI until SIGINT or SIGTERM; prints the port it
    listens on (port 0: an ephemeral one)."""
    import signal

    from .pipeline.server import _sigterm_to_exit

    server = make_server(analyzer, port)
    print(f"serving on port {server.server_address[1]} (web UI, "
          f"device={analyzer.device})", flush=True)
    old_term = signal.signal(signal.SIGTERM, _sigterm_to_exit)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        signal.signal(signal.SIGTERM, old_term)
        server.server_close()

