"""Browser-based interactive editor UI.

The reference editor is a native winit/wgpu/egui app (particle_editor/) — a
compute host is headless, so the interactive surface here is a small stdlib HTTP
server around the same ``Editor`` core, with the browser doing the GPU work:

- **Rendering**: particles ship to the browser as a compact binary payload
  (``/frame.bin``: 8 bytes/particle) and render client-side in ONE WebGL
  point-sprite draw call — the analog of the reference's single instanced
  quad draw (graphics.rs:311) — with velocity extrapolation between engine
  frames done in the vertex shader (shader.wgsl:96) and the same
  log-speed blue->red color ramp (shader.wgsl:94,100). This is what makes
  1M+ particles interactive; the server-side PNG path (``/frame.png``)
  remains as a no-WebGL fallback.
- **Editing**: the full toolbar (editor.rs:1443-1607) — brush/eraser/speed/
  clear with stroke w x h, square/hex grid, angle knob, random angle — is
  wired to ``/tool``; presets CRUD (editor.rs:961-1083) to ``/presets`` +
  control actions; "Edit & Resend current" (editor.rs:1087-1095) and the
  keyboard shortcuts (editor.rs:740-790) work from the browser.
- **GUI section** (editor.rs:1305-1411): UI scale, number format
  (dashed/scientific/metric, the NumFormatter analog — number_formatter.rs),
  background/slow/fast colors, max-speed-for-color, min particle px, render
  style (flat / shaded "RTX Ultra" sphere / animated "RTX RGB" ring —
  shader.wgsl:131-201), Over/Add blend with background-subtract
  (shader.wgsl:124), velocity-extrapolation toggle, significant digits,
  number color, cursor stroke, fullscreen, and Boom/Reconstruct (the
  floating-windows toggle, editor.rs:1403-1410 — here the side panel
  detaches into a draggable floating box over the canvas). All of these are
  client-side render state, exactly as in the reference.

Run (engine in another terminal):
    python -m particle_simulator_tpu_torch.editor.webview --http 127.0.0.1:8700
    python -m particle_simulator_tpu_torch.engine.daemon --addr 127.0.0.1:53123
then open http://127.0.0.1:8700

The port's own copy of ``particle_simulator_tpu/editor/webview.py``: the same
endpoints, flags, page and self-test vectors; the page names the engine's
accelerator ``GPU`` (the port's ``Device.GPU.display_name``) where the JAX
package's says ``TPU``. SIGTERM stops it like Ctrl-C, and on exit it names,
on standard error, any module of ``jax`` or of the JAX package it imported.
"""

from __future__ import annotations

import argparse
import json
import signal
import struct
import base64
import sys
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

import numpy as np

from particle_simulator_tpu_torch.editor.backend import Backend
from particle_simulator_tpu_torch.editor.core import Editor
from particle_simulator_tpu_torch.editor.render import render_frame
from particle_simulator_tpu_torch.editor.tools import (
    LatticeKind,
    Stroke,
    Tool,
    ToolOptions,
    lattice_resolution,
)
from particle_simulator_tpu_torch.utils.log import report_foreign_modules
from particle_simulator_tpu_torch.utils.numfmt import NumFormat, NumFormatter
_BIN_MAGIC = 0x4E494250  # "PBIN" little-endian
_BIN_HEADER = struct.Struct("<IIfffffffI")  # 40 bytes


_PAGE = """<!DOCTYPE html>
<html><head><title>particle_simulator_tpu</title><style>
body { background: #101018; color: #cfd2e0; font-family: monospace; margin: 0; display: flex; }
#side { width: 320px; padding: 12px; overflow-y: auto; height: 100vh; box-sizing: border-box; }
#view { position: relative; margin: 12px; }
canvas { position: absolute; left: 0; top: 0; }
#glcanvas { border: 1px solid #333; background: #0d0d14; }
#overlay { pointer-events: none; }
#viewbox { position: relative; cursor: crosshair; }
button { background: #26263a; color: #cfd2e0; border: 1px solid #444; margin: 2px; padding: 4px 10px; cursor: pointer; }
button.on { background: #3a5a3a; border-color: #6a6; }
input[type=range] { width: 100%; }
input[type=text] { background: #1a1a28; color: #cfd2e0; border: 1px solid #444; width: 120px; }
label { display: block; margin-top: 8px; font-size: 12px; }
h4 { margin: 14px 0 4px 0; border-bottom: 1px solid #333; }
#stats { white-space: pre-wrap; font-size: 11px; margin-top: 12px; color: #8f93a8; }
#fps { position: absolute; right: 6px; top: 4px; color: #8f93a8; font-size: 12px; z-index: 3; }
.preset { font-size: 12px; margin: 2px 0; }
.preset button { padding: 1px 6px; font-size: 11px; }
kbd { background: #26263a; padding: 0 4px; border-radius: 3px; }
</style></head><body>
<div id="side">
  <h3>particle simulator (GPU)</h3>
  <div>
    <button id="b_play" onclick="ctl('toggle_play')">play/pause</button>
    <button id="b_loop" onclick="ctl('toggle_loop')">loop</button>
    <button onclick="ctl('seek_live')">live</button>
    <button onclick="ctl('lattice', latticeOpts())">lattice</button>
    <button onclick="ctl('clear')">clear</button>
    <button onclick="ctl('clear_timeline')" title="free the stored frame history (Timeline RAM)">clear timeline</button>
    <button onclick="ctl('disconnect')">disconnect</button>
    <button onclick="ctl('connect_files')" title="connect via ./backend_out.bin / ./backend_in.bin">files/pipes</button>
  </div>
  <details><summary style="font-size:12px;cursor:pointer">lattice options</summary>
    <label>size <input type="number" id="lnx" value="50" min="1" style="width:56px">
      x <input type="number" id="lny" value="50" min="1" style="width:56px"></label>
    <label>distance factor <input type="number" id="ldf" value="1.1" step="0.05" style="width:64px"></label>
    <label>velocity min/max (m/s) <input type="number" id="lvmin" value="0" style="width:56px">
      &ndash; <input type="number" id="lvmax" value="0" style="width:56px"></label>
    <label>species <select id="lty"><option value="0" selected>0</option><option value="1">1</option></select>
      grid <select id="lhex"><option value="1" selected>hexagonal</option><option value="">square</option></select></label>
  </details>
  <label>play speed (log s/s) <input type="range" id="speed" min="-15" max="0" step="0.1" value="-11.3"
    oninput="ctl('speed', {value: Math.pow(10, this.value)})"></label>
  <label>seek <input type="range" id="seek" min="0" max="1000" value="1000"
    oninput="ctl('seek_frac', {value: this.value / 1000})"></label>

  <h4>tools</h4>
  <div id="toolbar">
    <button class="tool on" data-tool="cursor">cursor</button>
    <button class="tool" data-tool="brush">brush</button>
    <button class="tool" data-tool="eraser">eraser</button>
    <button class="tool" data-tool="speed">speed</button>
  </div>
  <label>stroke width (cells) <input type="range" id="tw" min="1" max="40" step="1" value="6"></label>
  <label>stroke height (cells) <input type="range" id="th" min="1" max="40" step="1" value="6"></label>
  <label>grid
    <select id="tlattice"><option value="hex" selected>hexagonal</option><option value="square">square</option></select>
  </label>
  <label>velocity (m/s) <input type="range" id="tvel" min="0" max="1000" step="5" value="0"></label>
  <label><input type="checkbox" id="trandom" checked> random angle</label>
  <label>angle (deg) <input type="range" id="tangle" min="0" max="360" step="1" value="90"></label>
  <label>species <select id="tty"><option value="0" selected>0</option><option value="1">1</option></select></label>
  <div>
    <button onclick="ctl('edit_resend'); setTool('cursor')">edit &amp; resend</button>
    <button onclick="ctl('edit_begin_empty'); setTool('brush')">new empty</button>
    <button onclick="ctl('edit_cancel'); setTool('cursor')">cancel edit</button>
  </div>
  <label><input type="checkbox" id="sendclear" onchange="ctl('toggle_send_clear')"> clear and send next</label>

  <h4>presets</h4>
  <div>
    <input type="text" id="pname" placeholder="name">
    <button onclick="presetSave()">save current</button>
    <button onclick="ctl('preset_update', {name: document.getElementById('pname').value}).then(presetRefresh)"
      title="write the in-progress edit back to the preset it came from">save edits</button>
  </div>
  <div id="presets"></div>

  <h4>parameters</h4>
  <label>cursor size <input type="range" id="csize" min="0.01" max="0.5" step="0.01" value="0.05"
    oninput="param('cursor_size', parseFloat(this.value))"></label>
  <label>dt (fs) <input type="range" id="dt" min="1" max="100" step="1" value="50"
    oninput="param('step_dt', this.value * 1e-15); updFrameDt()"></label>
  <label>steps/frame <input type="range" id="spf" min="1" max="500" step="1" value="100"
    oninput="param('steps_per_frame', parseInt(this.value)); updFrameDt()"></label>
  <div id="framedt" style="font-size:11px;color:#8f93a8"></div>
  <label>box width (nm) <input type="number" id="pboxw" value="50" step="5" min="1" style="width:64px"
    onchange="param('box_width', this.value * 1e-9)">
   height (nm) <input type="number" id="pboxh" value="50" step="5" min="1" style="width:64px"
    onchange="param('box_height', this.value * 1e-9)"></label>
  <label>gpu threads/block (log2) <input type="range" id="pgtb" min="0" max="10" step="1" value="7"
    oninput="param('gpu_threads_per_block_log2', parseInt(this.value))"></label>
  <!-- per-species Mie sliders: the reference panel shows BOTH species
       (editor.rs:828-1411); species 0 drives the physics, species 1 rides
       the metadata (kernel_bucket.cuh:52, doc/project.typ:610) -->
  <div style="font-size:11px;color:#8f93a8">species 0 (Nitrogen defaults)</div>
  <label>sigma (A) <input type="range" min="1" max="10" step="0.05" value="3.609"
    oninput="param('sigma0', this.value * 1e-10)"></label>
  <label>epsilon (K·kB) <input type="range" min="10" max="500" step="1" value="106"
    oninput="param('epsilon0', this.value * 1.380649e-23)"></label>
  <label>n (repulsive) <input type="range" min="7" max="20" step="0.1" value="14.08"
    oninput="param('n0', parseFloat(this.value))"></label>
  <label>m (attractive) <input type="range" min="3" max="7" step="0.1" value="6"
    oninput="param('m0', parseFloat(this.value))"></label>
  <div style="font-size:11px;color:#8f93a8">species 1 (Argon defaults)</div>
  <label>sigma (A) <input type="range" min="1" max="10" step="0.05" value="3.404"
    oninput="param('sigma1', this.value * 1e-10)"></label>
  <label>epsilon (K·kB) <input type="range" min="10" max="500" step="1" value="118"
    oninput="param('epsilon1', this.value * 1.380649e-23)"></label>
  <label>n (repulsive) <input type="range" min="7" max="20" step="0.1" value="12.085"
    oninput="param('n1', parseFloat(this.value))"></label>
  <label>m (attractive) <input type="range" min="3" max="7" step="0.1" value="6"
    oninput="param('m1', parseFloat(this.value))"></label>
  <label>data structure
    <select onchange="param('data_structure', parseInt(this.value))">
      <option value="1" selected>Matrix Buckets</option>
      <option value="0">Compact Array</option>
    </select></label>
  <label>device
    <select onchange="param('device', parseInt(this.value))">
      <option value="0" selected>GPU</option>
      <option value="1">CPU Thread Pool</option>
      <option value="2">CPU Main Thread</option>
    </select></label>
  <h4>gui</h4>
  <label>ui scale <input type="range" id="gscale" min="0.6" max="1.8" step="0.05" value="1"
    oninput="document.body.style.zoom = this.value"></label>
  <label>number format
    <select id="gnumfmt"><option value="metric" selected>metric</option>
      <option value="scientific">scientific</option><option value="dashed">dashed</option></select>
    significant digits <input type="number" id="gsig" min="1" max="8" value="4" style="width:40px">
  </label>
  <label>number color <input type="color" id="gnumcolor" value="#8f93a8"
    oninput="for (const id of ['stats','fps']) document.getElementById(id).style.color = this.value"></label>
  <label><input type="checkbox" id="gcstroke"> cursor stroke
    <span style="color:#666">(force radius shown while idle, editor.rs:398)</span></label>
  <label>style
    <select id="gstyle"><option value="0" selected>flat</option>
      <option value="1">RTX ultra (shaded)</option><option value="2">RTX rgb</option></select>
  </label>
  <label>blend
    <select id="gblend"><option value="over" selected>over</option><option value="add">add</option></select>
  </label>
  <label><input type="checkbox" id="ginterp" checked> velocity extrapolation</label>
  <label>max speed for color (log10 m/s) <input type="range" id="gmaxspeed" min="0" max="4" step="0.05" value="3"></label>
  <label>min particle px <input type="range" id="gminpx" min="0.5" max="8" step="0.5" value="1.5"></label>
  <label>background <input type="color" id="gbg" value="#0d0d14">
    slow <input type="color" id="gcslow" value="#0033ff">
    fast <input type="color" id="gcfast" value="#ff3300"></label>
  <button onclick="document.getElementById('viewbox').requestFullscreen()">fullscreen</button>
  <button id="b_boom" onclick="toggleBoom()"
    title="detach the panel into a floating window over the canvas (editor.rs:1403-1410)">boom</button>

  <div id="stats"></div>
  <div id="selftest" style="font-size:11px;margin-top:6px"></div>
  <div style="font-size:11px;color:#666;margin-top:8px">
    <kbd>space</kbd> play <kbd>&larr;&rarr;</kbd> seek <kbd>L</kbd> lattice
    <kbd>C</kbd> clear timeline <kbd>X</kbd> clear scene <kbd>D</kbd> disconnect <kbd>B</kbd>rush <kbd>E</kbd>raser
    <kbd>S</kbd>peed <kbd>V</kbd> cursor <kbd>enter</kbd> resend <kbd>esc</kbd> cancel
  </div>
</div>
<div id="view">
  <div id="viewbox" style="width:720px;height:720px">
    <canvas id="glcanvas" width="720" height="720"></canvas>
    <canvas id="overlay" width="720" height="720"></canvas>
    <div id="fps"></div>
  </div>
</div>
<script>
'use strict';
const W = 720, H = 720;
const glc = document.getElementById('glcanvas');
const overlay = document.getElementById('overlay');
const octx = overlay.getContext('2d');
const viewbox = document.getElementById('viewbox');
// webgl2 first: its ES 3.0 signed-normalized rule max(v/32767, -1) is what
// dequantParticle models; the webgl1 fallback (ES 2.0: (2c+1)/65535) differs
// by <= 1.5e-5 * vscale for small velocities — documented divergence only on
// browsers without webgl2
const gl = glc.getContext('webgl2', {antialias: false, preserveDrawingBuffer: true})
        || glc.getContext('webgl', {antialias: false, preserveDrawingBuffer: true});

function post(url, body) { return fetch(url, {method: 'POST', body: JSON.stringify(body || {})}); }
function ctl(action, extra) { return post('/control', Object.assign({action}, extra)); }
function updFrameDt() {  /* "Frame delta time" readout (editor.rs:1115-1118) */
  const dt = parseFloat(document.getElementById('dt').value) * 1e-15;
  const spf = parseInt(document.getElementById('spf').value);
  document.getElementById('framedt').textContent =
    'frame delta time: ' + fmtNum(dt * spf, 's');
}
function latticeOpts() {  /* the lattice sub-panel (editor.rs:878-942) */
  return {
    nx: parseInt(document.getElementById('lnx').value) || 50,
    ny: parseInt(document.getElementById('lny').value) || 50,
    distance_factor: parseFloat(document.getElementById('ldf').value) || 1.1,
    vmin: parseFloat(document.getElementById('lvmin').value) || 0,
    vmax: parseFloat(document.getElementById('lvmax').value) || 0,
    ty: parseInt(document.getElementById('lty').value) || 0,
    hex: !!document.getElementById('lhex').value,
  };
}
function param(name, value) { post('/params', {[name]: value}); }

// ---- tools ----
let activeTool = 'cursor';
function setTool(t) {
  activeTool = t;
  document.querySelectorAll('#toolbar .tool').forEach(b =>
    b.classList.toggle('on', b.dataset.tool === t));
}
document.querySelectorAll('#toolbar .tool').forEach(b =>
  b.onclick = () => setTool(b.dataset.tool));
function toolOptions() {
  return {
    width_cells: parseFloat(document.getElementById('tw').value),
    height_cells: parseFloat(document.getElementById('th').value),
    lattice: document.getElementById('tlattice').value,
    velocity: parseFloat(document.getElementById('tvel').value),
    angle: document.getElementById('trandom').checked ? null :
           parseFloat(document.getElementById('tangle').value) * Math.PI / 180,
    ty: parseInt(document.getElementById('tty').value),
  };
}

// ---- mouse: cursor force OR tool strokes ----
let down = false, lastPt = null, mousePt = null;
function norm(e) {
  const r = viewbox.getBoundingClientRect();
  return {x: (e.clientX - r.left) / r.width, y: 1 - (e.clientY - r.top) / r.height};
}
function cursor(p, isDown) { post('/cursor', {x: p.x, y: p.y, down: isDown}); }
function strokeSeg(pts) { post('/tool', Object.assign({tool: activeTool, points: pts}, toolOptions())); }
viewbox.onmousedown = e => {
  down = true;
  const p = norm(e);
  if (activeTool === 'cursor') cursor(p, true);
  else { strokeSeg([[p.x, p.y]]); lastPt = p; }
};
viewbox.onmouseup = e => {
  down = false;
  if (activeTool === 'cursor') cursor(norm(e), false);
  lastPt = null;
};
viewbox.onmousemove = e => {
  mousePt = norm(e);
  if (!down) return;
  const p = mousePt;
  if (activeTool === 'cursor') cursor(p, true);
  else if (lastPt) { strokeSeg([[lastPt.x, lastPt.y], [p.x, p.y]]); lastPt = p; }
};
viewbox.onmouseleave = e => {
  if (down) { down = false; if (activeTool === 'cursor') cursor(norm(e), false); }
  mousePt = null; lastPt = null;
};

// ---- keyboard shortcuts (editor.rs:740-790) ----
document.onkeydown = e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'SELECT') return;
  const k = e.key.toLowerCase();
  if (k === ' ') { ctl('toggle_play'); e.preventDefault(); }
  else if (k === 'arrowleft') ctl('seek_frames', {delta: e.shiftKey ? -10 : -1});
  else if (k === 'arrowright') ctl('seek_frames', {delta: e.shiftKey ? 10 : 1});
  else if (k === 'l') ctl('lattice', latticeOpts());
  else if (k === 'c') ctl('clear_timeline');  // editor.rs:770-772: C = simulation.clear()
  else if (k === 'x') ctl('clear');           // extension: empty-scene send
  else if (k === 'd') ctl('disconnect');
  else if (k === 'b') setTool('brush');
  else if (k === 'e') setTool('eraser');
  else if (k === 's') setTool('speed');
  else if (k === 'v') setTool('cursor');
  else if (k === 'enter') { ctl('edit_resend'); setTool('cursor'); }
  else if (k === 'escape') { ctl('edit_cancel'); setTool('cursor'); }
};

// ---- presets ----
const escHtml = s => String(s).replace(/[&<>\\u0022\\u0027]/g,
  c => '&#' + c.charCodeAt(0) + ';');
async function presetRefresh() {
  const list = await (await fetch('/presets')).json();
  document.getElementById('presets').innerHTML = list.map((p, i) =>
    `<div class="preset">${escHtml(p.name)} (${p.count})
     <button onclick="ctl('preset_send',{index:${i}})">send</button>
     <button onclick="ctl('preset_edit',{index:${i}})" title="open in editing mode">edit</button>
     <button onclick="ctl('preset_duplicate',{index:${i}}).then(presetRefresh)">dup</button>
     <button onclick="ctl('preset_delete',{index:${i}}).then(presetRefresh)">x</button></div>`
  ).join('');
}
async function presetSave() {
  await ctl('preset_save', {name: document.getElementById('pname').value || 'preset'});
  presetRefresh();
}
presetRefresh();
updFrameDt();

// ---- WebGL point renderer (one draw call; graphics.rs:311 analog) ----
const VS = `
attribute vec2 a_pos;  // u16 normalized -> [0,1) box fraction
attribute vec2 a_vel;  // i16 normalized -> [-1,1] * u_vscale m/s
uniform float u_dt;    // sim seconds to extrapolate (shader.wgsl:96)
uniform float u_vscale;
uniform vec2 u_box;    // box size, meters
uniform float u_psize;
uniform float u_maxspeed;
uniform vec3 u_cslow;  // color ramp endpoints (shader.wgsl:94,100)
uniform vec3 u_cfast;
varying vec3 v_color;
void main() {
  vec2 vel = a_vel * u_vscale;
  vec2 p = a_pos + vel * u_dt / u_box;
  gl_Position = vec4(p * 2.0 - 1.0, 0.0, 1.0);
  gl_PointSize = u_psize;
  float rel = log2(1.0 + length(vel)) / log2(1.0 + u_maxspeed);
  v_color = mix(u_cslow, u_cfast, clamp(rel, 0.0, 1.0));
}`;
const FS = `
precision mediump float;
varying vec3 v_color;
uniform int u_style;   // 0 flat | 1 shaded sphere (shiny_circle, shader.wgsl:179-201)
                       // | 2 animated rainbow ring (shiny2_circle, shader.wgsl:131-177)
uniform float u_time;
uniform vec3 u_bg;
uniform float u_sub;   // 1.0 under Add blend: background-subtract (shader.wgsl:124)
void main() {
  vec2 d = (gl_PointCoord - 0.5) * 2.0;
  float r2 = dot(d, d);
  if (r2 > 1.0) discard;
  vec3 c = v_color;
  if (u_style == 1) {
    vec3 nrm = vec3(d.x, -d.y, sqrt(max(0.0, 1.0 - r2)));
    vec3 l = normalize(vec3(-0.4, 0.6, 0.8));
    float diff = max(dot(nrm, l), 0.0);
    float spec = pow(max(dot(reflect(-l, nrm), vec3(0.0, 0.0, 1.0)), 0.0), 16.0);
    c = c * (0.25 + 0.75 * diff) + vec3(0.6) * spec;
  } else if (u_style == 2) {
    float hue = fract(atan(d.y, d.x) / 6.2831853 + 0.5 + u_time * 0.25);
    vec3 rgb = clamp(abs(mod(hue * 6.0 + vec3(0.0, 4.0, 2.0), 6.0) - 3.0) - 1.0, 0.0, 1.0);
    float ring = smoothstep(1.0, 0.55, r2) * (0.35 + 0.65 * smoothstep(0.15, 0.75, r2));
    c = mix(v_color, rgb, 0.85) * ring;
  }
  gl_FragColor = vec4(c - u_sub * u_bg, 1.0);
}`;
function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
gl.useProgram(prog);
const buf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, buf);
const aPos = gl.getAttribLocation(prog, 'a_pos');
const aVel = gl.getAttribLocation(prog, 'a_vel');
gl.enableVertexAttribArray(aPos);
gl.enableVertexAttribArray(aVel);
gl.vertexAttribPointer(aPos, 2, gl.UNSIGNED_SHORT, true, 8, 0);
gl.vertexAttribPointer(aVel, 2, gl.SHORT, true, 8, 4);
// uniform locations are immutable after linkProgram: resolve each once
const _uloc = {};
const U = n => n in _uloc ? _uloc[n] : (_uloc[n] = gl.getUniformLocation(prog, n));

// ---- gui render state (editor.rs:1305-1411) ----
function hexRgb(h) {
  return [parseInt(h.slice(1, 3), 16) / 255,
          parseInt(h.slice(3, 5), 16) / 255,
          parseInt(h.slice(5, 7), 16) / 255];
}
function guiState() {
  return {
    style: parseInt(document.getElementById('gstyle').value),
    add: document.getElementById('gblend').value === 'add',
    interp: document.getElementById('ginterp').checked,
    maxspeed: Math.pow(10, parseFloat(document.getElementById('gmaxspeed').value)),
    minpx: parseFloat(document.getElementById('gminpx').value),
    bg: hexRgb(document.getElementById('gbg').value),
    cslow: hexRgb(document.getElementById('gcslow').value),
    cfast: hexRgb(document.getElementById('gcfast').value),
  };
}

// ---- number formats (number_formatter.rs: Dashed / Scientific / Metric) ----
// Mirrors utils/numfmt.py NumFormatter (significant=4) STEP FOR STEP so the
// Python-generated SELFTEST vectors pin both implementations to one spec.
const SUP = {'-': '\\u207b', '0': '\\u2070', '1': '\\u00b9', '2': '\\u00b2', '3': '\\u00b3',
             '4': '\\u2074', '5': '\\u2075', '6': '\\u2076', '7': '\\u2077', '8': '\\u2078', '9': '\\u2079'};
const SI = [[1e9, 'G'], [1e6, 'M'], [1e3, 'k'], [1, ''], [1e-3, 'm'], [1e-6, '\\u00b5'],
            [1e-9, 'n'], [1e-12, 'p'], [1e-15, 'f']];
const FMT_SIG = 4;  // NumFormatter's default significant figures
function fmtSig() {  // "Significant Digits" DragValue, 1..=8 (editor.rs:1327-1329)
  const el = document.getElementById('gsig');
  const v = el ? parseInt(el.value, 10) : FMT_SIG;
  return isNaN(v) ? FMT_SIG : Math.min(8, Math.max(1, v));
}
function trimNum(s) {  // numfmt._trim: rstrip zeros then the dot
  if (s.indexOf('.') < 0) return s;
  s = s.replace(/0+$/, '');
  return s.slice(-1) === '.' ? s.slice(0, -1) : s;
}
function groupUnderscores(s) {  // numfmt.format_with_underscores
  let sign = '';
  if (s[0] === '+' || s[0] === '-') { sign = s[0]; s = s.slice(1); }
  const di = s.indexOf('.');
  const ip = di < 0 ? s : s.slice(0, di);
  const frac = di < 0 ? '' : s.slice(di);
  return sign + ip.replace(/\\B(?=(\\d{3})+(?!\\d))/g, '_') + frac;
}
function fmtNum(x, unit, fmt, sigArg) {
  unit = unit || '';
  if (typeof x !== 'number' || !isFinite(x)) return String(x) + unit;
  fmt = fmt || document.getElementById('gnumfmt').value;
  // explicit sig wins: runSelfTest pins 4 (the vectors' significant) so a
  // browser-restored #gsig value can never fail the self-test contract
  const sig = (sigArg == null) ? fmtSig() : sigArg;
  const v = x === 0 ? 0 : Number(x.toPrecision(sig));  // numfmt._round_sig
  if (fmt === 'dashed') {
    // toFixed returns exponential notation for |v| >= 1e21; Python prints
    // full digits there — use a non-grouping locale render (integral by
    // construction at that magnitude) to match
    const big = Math.abs(v) >= 1e21;
    const body = !v ? '0' : trimNum(big
      ? v.toLocaleString('en-US', {useGrouping: false, maximumFractionDigits: 0})
      : v.toFixed(sig));
    return groupUnderscores(body) + unit;
  }
  if (fmt === 'scientific') {
    if (v === 0) return '0' + unit;
    const me = v.toExponential(sig - 1).split('e');  // exact-decimal exp
    const mant = trimNum(me[0]);
    const exp = parseInt(me[1], 10);
    if (exp === 0) return mant + unit;
    const sup = String(exp).split('').map(c => SUP[c] || c).join('');
    return mant + '\\u00b710' + sup + unit;
  }
  // metric (SI prefixes G..f, femto fallback like numfmt.py:100-101)
  if (v === 0) return '0' + unit;
  for (const [scale, prefix] of SI) {
    if (Math.abs(v) >= scale || scale === 1e-15) {
      return trimNum((v / scale).toFixed(sig - 1)) + prefix + unit;
    }
  }
  return String(v) + unit;
}
gl.clearColor(0.05, 0.05, 0.08, 1.0);

// ---- frame fetch loop (engine-rate) + rAF render (display-rate) ----
let cur = null;  // {count, frameTime, playTime, playSpeed, boxW, boxH, vscale, sigma, flags, fetchedAt}
function parsePBIN(ab) {  // 40-byte header (frame_bin docstring); null if not PBIN
  const dv = new DataView(ab);
  if (ab.byteLength < 40 || dv.getUint32(0, true) !== 0x4e494250) return null;
  return {
    count: dv.getUint32(4, true),
    frameTime: dv.getFloat32(8, true),
    playTime: dv.getFloat32(12, true),
    playSpeed: dv.getFloat32(16, true),
    boxW: dv.getFloat32(20, true),
    boxH: dv.getFloat32(24, true),
    vscale: dv.getFloat32(28, true),
    sigma: dv.getFloat32(32, true),
    flags: dv.getUint32(36, true),
  };
}
function dequantParticle(ab, h, i) {  // the GL attribute pipeline, in JS:
  // u16 normalized -> box fraction (v/65535); i16 normalized -> clamp(v/32767,
  // -1, 1) * vscale m/s (vertexAttribPointer normalized SHORT semantics)
  const dv = new DataView(ab, 40 + 8 * i, 8);
  return [dv.getUint16(0, true) / 65535, dv.getUint16(2, true) / 65535,
          Math.max(dv.getInt16(4, true) / 32767, -1) * h.vscale,
          Math.max(dv.getInt16(6, true) / 32767, -1) * h.vscale];
}
function extrapDt(f, nowMs) {  // sim-seconds the shader extrapolates (shader.wgsl:96)
  const playing = (f.flags & 2) !== 0 && (f.flags & 1) === 0;
  const wallDt = playing ? (nowMs - f.fetchedAt) / 1000 * f.playSpeed : 0;
  return (f.playTime - f.frameTime) + wallDt;
}
let fetching = false;
async function fetchFrame() {
  if (fetching) return;
  fetching = true;
  try {
    const r = await fetch('/frame.bin');
    const ab = await r.arrayBuffer();
    const f = parsePBIN(ab);
    if (!f) return;
    f.fetchedAt = performance.now();
    gl.bindBuffer(gl.ARRAY_BUFFER, buf);
    gl.bufferData(gl.ARRAY_BUFFER, new Uint8Array(ab, 40), gl.DYNAMIC_DRAW);
    cur = f;
  } catch (e) { /* server paused/restarting */ }
  finally { fetching = false; }
}
setInterval(fetchFrame, 50);
fetchFrame();

let frames = 0, fpsT = performance.now();
window.__fps = 0;
function draw() {
  requestAnimationFrame(draw);
  const g = guiState();
  gl.viewport(0, 0, W, H);
  gl.clearColor(g.bg[0], g.bg[1], g.bg[2], 1.0);
  gl.clear(gl.COLOR_BUFFER_BIT);
  if (cur && cur.count > 0) {
    if (g.add) { gl.enable(gl.BLEND); gl.blendFunc(gl.ONE, gl.ONE); }
    else gl.disable(gl.BLEND);
    gl.uniform1f(U('u_dt'), g.interp ? extrapDt(cur, performance.now()) : 0.0);
    gl.uniform1f(U('u_vscale'), cur.vscale);
    gl.uniform2f(U('u_box'), cur.boxW, cur.boxH);
    gl.uniform1f(U('u_psize'), Math.max(g.minpx, cur.sigma / cur.boxW * W));
    gl.uniform1f(U('u_maxspeed'), g.maxspeed);
    gl.uniform3f(U('u_cslow'), g.cslow[0], g.cslow[1], g.cslow[2]);
    gl.uniform3f(U('u_cfast'), g.cfast[0], g.cfast[1], g.cfast[2]);
    gl.uniform1i(U('u_style'), g.style);
    gl.uniform1f(U('u_time'), performance.now() / 1000 % 3600);
    gl.uniform3f(U('u_bg'), g.bg[0], g.bg[1], g.bg[2]);
    gl.uniform1f(U('u_sub'), g.add ? 1.0 : 0.0);
    gl.drawArrays(gl.POINTS, 0, cur.count);
  }
  drawOverlay();
  frames++;
  const now = performance.now();
  if (now - fpsT > 1000) {
    window.__fps = frames * 1000 / (now - fpsT);
    document.getElementById('fps').textContent =
      window.__fps.toFixed(0) + ' fps / ' + (cur ? cur.count : 0) + ' particles';
    frames = 0; fpsT = now;
  }
}
requestAnimationFrame(draw);

// ---- overlay: engine cursor ghost + brush footprint ----
let ghost = null, cellFrac = {x: 0.01, y: 0.01}, cursorFrac = 0.05;
function drawOverlay() {
  octx.clearRect(0, 0, W, H);
  if (ghost && ghost.x >= 0) {
    octx.strokeStyle = 'rgba(255,255,255,0.5)';
    octx.beginPath();
    octx.arc(ghost.x * W, (1 - ghost.y) * H, ghost.size / 2 * W, 0, 2 * Math.PI);
    octx.stroke();
  }
  if (mousePt && activeTool !== 'cursor') {
    const w = parseFloat(document.getElementById('tw').value) * cellFrac.x * W;
    const h = parseFloat(document.getElementById('th').value) * cellFrac.y * H;
    octx.strokeStyle = activeTool === 'eraser' ? 'rgba(255,80,80,0.7)' : 'rgba(120,255,120,0.7)';
    octx.strokeRect(mousePt.x * W - w / 2, (1 - mousePt.y) * H - h / 2, w, h);
  }
  // local cursor-force radius ring: while pressed, or always with the
  // "cursor stroke" GUI checkbox on (editor.rs:388-399, white_alpha(50))
  if (mousePt && activeTool === 'cursor' &&
      (down || document.getElementById('gcstroke').checked)) {
    octx.strokeStyle = 'rgba(255,255,255,0.2)';
    octx.beginPath();
    octx.arc(mousePt.x * W, (1 - mousePt.y) * H, cursorFrac / 2 * W, 0, 2 * Math.PI);
    octx.stroke();
  }
}

// ---- Boom / Reconstruct: detach the panel into a floating window ----------
// (editor.rs:1403-1410 floating_windows; the browser analog floats the whole
// side panel over the canvas, draggable by its title)
let boomDrag = null;
function toggleBoom() {
  const side = document.getElementById('side');
  const floating = side.style.position !== 'fixed';
  side.style.position = floating ? 'fixed' : '';
  side.style.left = floating ? '60px' : '';
  side.style.top = floating ? '40px' : '';
  side.style.zIndex = floating ? '10' : '';
  side.style.height = floating ? '80vh' : '';
  side.style.background = floating ? 'rgba(16,16,24,0.92)' : '';
  side.style.border = floating ? '1px solid #444' : '';
  document.getElementById('b_boom').textContent = floating ? 'reconstruct' : 'boom';
}
document.querySelector('#side h3').onmousedown = e => {
  const side = document.getElementById('side');
  if (side.style.position !== 'fixed') return;
  boomDrag = {dx: e.clientX - side.offsetLeft, dy: e.clientY - side.offsetTop};
  e.preventDefault();
};
window.addEventListener('mousemove', e => {
  if (!boomDrag) return;
  const side = document.getElementById('side');
  side.style.left = (e.clientX - boomDrag.dx) + 'px';
  side.style.top = (e.clientY - boomDrag.dy) + 'px';
});
window.addEventListener('mouseup', () => { boomDrag = null; });

// stats panel (editor.rs:1228-1289), numbers through the selected format
function statsText(s) {
  const lines = [
    'time: ' + fmtNum(s.time, 's'),
    'frame time: ' + (s.frame_time === null ? '-' : fmtNum(s.frame_time, 's'))
      + ' / ' + fmtNum(s.sim_len, 's'),
    'frame: ' + (s.frame_index === null ? '-' : s.frame_index) + ' / ' + s.frame_count,
    'step dt: ' + fmtNum(s.step_dt, 's'),
    'particles: ' + fmtNum(s.particle_count, ''),
    'data structure: ' + s.data_structure,
    'device: ' + s.device,
    'timeline ram: ' + fmtNum(s.timeline_ram, 'B'),
    'interactive: ' + s.interactive + (s.editing ? ' (editing)' : ''),
    'connection: ' + s.connection,
    'reader/writer: ' + (s.reader_connected ? 'connected' : 'disconnected')
      + ' / ' + (s.writer_connected ? 'connected' : 'disconnected'),
    'tcp server: ' + s.tcp_server,
  ];
  return lines.join('\\n');
}
setInterval(async () => {
  try {
    const s = await (await fetch('/stats')).json();
    ghost = s.engine_cursor || null;
    if (s.cell_frac) cellFrac = s.cell_frac;
    if (typeof s.cursor_frac === 'number') cursorFrac = s.cursor_frac;
    document.getElementById('b_play').classList.toggle('on', !!s.interactive);
    document.getElementById('b_loop').classList.toggle('on', !!s.loop);
    document.getElementById('sendclear').checked = !!s.send_clear;
    document.getElementById('stats').textContent = statsText(s);
  } catch (e) {}
}, 500);

// ---- in-page self-test -------------------------------------------------------
// There is no JS engine in CI, so the executable coverage for this script runs
// HERE: the server embeds golden vectors generated by the PYTHON reference
// implementations (utils/numfmt.py NumFormatter, frame_bin's PBIN encoder, the
// extrapolation spec), the page replays them through the live fmtNum /
// parsePBIN / dequantParticle / extrapDt on every load, and POSTs the result
// to /selftest (surfaced in /stats as "selftest" — tests/test_webview.py
// asserts the vectors match the Python side, any real browser asserts the JS).
const SELFTEST = "__SELFTEST_JSON__";
function runSelfTest() {
  const fails = [];
  let checks = 0;
  const near = (a, b, tol) => Math.abs(a - b) <= tol * Math.max(1, Math.abs(b));
  const expect = (ok, msg) => { checks++; if (!ok) fails.push(msg); };
  try {
    for (const [x, unit, fmt, want] of SELFTEST.fmt) {
      const got = fmtNum(x, unit, fmt, 4);
      expect(got === want, 'fmtNum(' + x + ',' + fmt + '): "' + got + '" != "' + want + '"');
    }
    const raw = atob(SELFTEST.pbin.b64);
    const ab = new ArrayBuffer(raw.length);
    const u8 = new Uint8Array(ab);
    for (let i = 0; i < raw.length; i++) u8[i] = raw.charCodeAt(i);
    const h = parsePBIN(ab), want = SELFTEST.pbin.expected;
    expect(!!h, 'parsePBIN rejected the golden header');
    if (h) {
      for (const k of ['count', 'flags'])
        expect(h[k] === want[k], 'pbin.' + k + ': ' + h[k] + ' != ' + want[k]);
      for (const k of ['frameTime', 'playTime', 'playSpeed', 'boxW', 'boxH', 'vscale', 'sigma'])
        expect(near(h[k], want[k], 1e-7), 'pbin.' + k + ': ' + h[k] + ' != ' + want[k]);
      for (let i = 0; i < want.particles.length; i++) {
        const got = dequantParticle(ab, h, i);
        for (let j = 0; j < 4; j++)
          expect(near(got[j], want.particles[i][j], 1e-9),
                 'pbin p' + i + '[' + j + ']: ' + got[j] + ' != ' + want.particles[i][j]);
      }
    }
    for (const c of SELFTEST.extrap) {
      const got = extrapDt({frameTime: c[0], playTime: c[1], playSpeed: c[2],
                            flags: c[3], fetchedAt: c[4]}, c[5]);
      expect(near(got, c[6], 1e-12), 'extrapDt: ' + got + ' != ' + c[6]);
    }
    // the GL pipeline itself: context up, shaders linked (shader() throws on
    // compile errors before we get here), no pending error
    expect(!!gl, 'webgl context creation failed');
    if (gl) expect(gl.getError() === gl.NO_ERROR, 'webgl error flag set');
  } catch (e) { checks++; fails.push('exception: ' + e); }
  post('/selftest', {total: checks, failed: fails.length, failures: fails.slice(0, 20)});
  const el = document.getElementById('selftest');
  el.textContent = 'js self-test: ' + (fails.length
      ? fails.length + '/' + checks + ' FAILED — ' + fails[0] : checks + '/' + checks + ' ok');
  el.style.color = fails.length ? '#e66' : '#6a6';
}
runSelfTest();
</script></body></html>"""


def extrap_dt_spec(frame_time: float, play_time: float, play_speed: float,
                   flags: int, fetched_at_ms: float, now_ms: float) -> float:
    """The spec for the browser's velocity-extrapolation time: sim-seconds the
    vertex shader advances positions by (shader.wgsl:96 analog). Extrapolation
    runs only while auto-playing (flags bit1) and not editing (flags bit0);
    the wall-clock gap since the payload was fetched scales by play_speed and
    stacks on the frame→play-cursor gap the server already reports."""
    playing = (flags & 2) != 0 and (flags & 1) == 0
    wall = (now_ms - fetched_at_ms) / 1000.0 * play_speed if playing else 0.0
    return (play_time - frame_time) + wall


def selftest_vectors() -> dict:
    """Golden vectors for the page's in-page JS self-test (runSelfTest).

    Generated by the PYTHON reference implementations so one spec pins both
    languages: fmtNum mirrors utils/numfmt.py NumFormatter (significant=4),
    parsePBIN/dequantParticle mirror frame_bin's encoding + the GL normalized
    attribute rules, extrapDt mirrors extrap_dt_spec. tests/test_webview.py
    asserts these vectors against the Python side and independently re-decodes
    the PBIN golden; a real browser asserts the JS side on every page load.
    Tie values (exact decimal .5 at the 5th significant digit) are excluded:
    Python rounds half-even, JS toPrecision half-up."""
    fmt_cases = []
    for fmt, vals in {
        "metric": [(0.0, "s"), (5e-14, "s"), (1500.0, ""), (2.5e-7, "s"),
                   (1.5e9, "B"), (-0.00042, "s"), (9.87e-16, "s"),
                   (123.456, ""), (1048576.0, "B")],
        "scientific": [(0.0, "s"), (1.0, "s"), (6.022e23, ""), (-2.5e-7, "s"),
                       (0.001, "s"), (42.0, ""),
                       # decade boundaries: floor(log10) lands on an edge
                       (1e-7, "s"), (999.95, ""), (9.9999e2, ""), (1e21, "")],
        "dashed": [(0.0, ""), (1234567.89, ""), (-1234.56, ""), (0.05, "s"),
                   (3.14159, ""), (2500.0, ""),
                   # |v| >= 1e21: JS toFixed would go exponential (handled)
                   (1e21, ""), (-1e21, "")],
    }.items():
        f = NumFormatter(NumFormat(fmt), significant=4)
        for x, unit in vals:
            fmt_cases.append([x, unit, fmt, f.format(x, unit)])

    # PBIN golden: 3 hand-picked quantized records through the real header
    # layout; p2.vx = -32768 exercises the GL SHORT-normalized clamp to -1
    body = np.zeros(3, dtype=[("x", "<u2"), ("y", "<u2"), ("vx", "<i2"), ("vy", "<i2")])
    body[0] = (0, 65535, 32767, -32767)
    body[1] = (32768, 16384, 0, 1)
    body[2] = (12345, 54321, -32768, 12345)
    hdr = (0.25, 0.75, 2.0, 5e-8, 4e-8, 800.0, 3.4e-10)
    blob = _BIN_HEADER.pack(_BIN_MAGIC, len(body), *hdr, 2) + body.tobytes()
    f32 = lambda v: float(np.float32(v))  # noqa: E731 - DataView.getFloat32 widening
    vscale = f32(800.0)
    expected = {
        "count": len(body), "frameTime": f32(0.25), "playTime": f32(0.75),
        "playSpeed": f32(2.0), "boxW": f32(5e-8), "boxH": f32(4e-8),
        "vscale": vscale, "sigma": f32(3.4e-10), "flags": 2,
        "particles": [
            [int(r["x"]) / 65535, int(r["y"]) / 65535,
             max(int(r["vx"]) / 32767, -1) * vscale,
             max(int(r["vy"]) / 32767, -1) * vscale]
            for r in body
        ],
    }

    extrap = []
    for ft, pt, speed, flags, fetched, now in [
        (0.0, 1.5e-12, 1e-11, 2, 0.0, 500.0),     # playing: += 0.5 s wall * speed
        (0.0, 1.5e-12, 1e-11, 3, 0.0, 500.0),     # editing (bit0) gates extrapolation
        (1e-12, 1.5e-12, 1e-11, 0, 100.0, 600.0),  # paused: frame->cursor gap only
    ]:
        extrap.append([ft, pt, speed, flags, fetched, now,
                       extrap_dt_spec(ft, pt, speed, flags, fetched, now)])

    return {
        "fmt": fmt_cases,
        "pbin": {"b64": base64.b64encode(blob).decode(), "expected": expected},
        "extrap": extrap,
    }


def render_page() -> str:
    """The UI page with the self-test golden vectors baked in."""
    return _PAGE.replace('"__SELFTEST_JSON__"', json.dumps(selftest_vectors()))


class WebEditor:
    """Editor core + ticking thread + render cache, shared by HTTP handlers."""

    # Loopback by default: the engine-facing port accepts raw, unauthenticated
    # scene frames — binding all interfaces must be an explicit opt-in (--addr).
    def __init__(self, backend_addr=("127.0.0.1", 53123), size: int = 512,
                 presets_dir: str | None = None):
        self.editor = Editor(Backend(addr=backend_addr))
        self.size = size
        self.presets_dir = presets_dir
        if presets_dir:
            from particle_simulator_tpu_torch.io.presets import Presets

            self.editor.presets = Presets.load_dir(presets_dir)
        self._bin_cache = None  # (frame, count, vmax, body bytes)
        self._vmax_scale = None  # smoothed velocity quantization scale
        self.selftest = None  # last in-page JS self-test result (POST /selftest)
        self.lock = threading.Lock()
        # serializes _persist_presets end-to-end: ThreadingHTTPServer handles
        # each request on its own thread, and two overlapping write_dir calls
        # would collide on tmp names / resurrect deleted presets
        self._persist_lock = threading.Lock()
        self._stop = False
        self._rng = np.random.default_rng()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        last = time.monotonic()
        was_connected = False
        while not self._stop:
            now = time.monotonic()
            with self.lock:
                self.editor.tick(now - last)
                # engine (re)connected after a scene was drawn: re-send it so
                # a late-starting engine picks up the current scene
                connected = self.editor.backend.is_connected
                if connected and not was_connected and self.editor.last_scene is not None:
                    self.editor.backend.write(self.editor.last_scene)
                was_connected = connected
            last = now
            time.sleep(0.01)

    # -- rendering --------------------------------------------------------------
    def _display_snapshot(self):
        """(frame, exact, play_time, play_speed, flags) safe to read outside
        the lock: timeline frames are immutable once pushed, but the
        in-progress EDIT frame is mutated by /tool under the lock — copy it so
        the encoders never see a torn extend()/in-place write."""
        with self.lock:
            frame, exact = self.editor.display_frame()
            if self.editor.editing and frame is not None:
                frame = frame.copy()
            flags = (1 if self.editor.editing else 0) | (
                2 if self.editor.auto_play else 0
            )
            return frame, exact, self.editor.play_time, self.editor.play_speed, flags

    def frame_png(self) -> bytes:
        frame, exact, play_time, _, _ = self._display_snapshot()
        if frame is None:
            img = np.full((self.size, self.size, 3), 16, np.uint8)
        else:
            img = render_frame(
                frame, self.size, self.size, sim_time=play_time, frame_time=exact
            )
        return _png_bytes(img)

    def frame_bin(self) -> tuple:
        """Compact binary particle payload for the browser's WebGL renderer,
        as (header bytes, body bytes) — concatenate for the wire form.

        Layout (little-endian):
          header (40 B): u32 magic "PBIN" | u32 count | f32 frame_time
                         | f32 play_time | f32 play_speed | f32 box_w
                         | f32 box_h | f32 vscale | f32 sigma0 | u32 flags
                         (flags bit0 = editing, bit1 = auto_play)
          body: count * 8 B: u16 x | u16 y | i16 vx_q | i16 vy_q
                positions are box fractions (x/65535); velocities are
                vq/32767 * vscale m/s.
        """
        frame, exact, play_time, play_speed, flags = self._display_snapshot()
        if frame is None:
            self._bin_cache = None  # don't pin the last scene's ~28 MB at 1M
            return (_BIN_HEADER.pack(_BIN_MAGIC, 0, 0.0, 0.0, play_speed, 1.0, 1.0,
                                     1.0, 0.0, flags), b"")
        meta = frame.metadata
        # Body cache: timeline frames are immutable once pushed and the
        # browser polls much faster than the engine ships (~40 ms encode at
        # 1M x ~20 Hz poll otherwise burns a CPU core); only the 40-byte
        # header changes between polls. Edit-mode frames are fresh copies
        # each snapshot, so they miss the cache and re-encode live strokes.
        cached = self._bin_cache
        if cached is not None and cached[0] is frame:
            n, vmax, body_bytes = cached[1], cached[2], cached[3]
        else:
            parts = frame.particles
            live = parts["ty"] >= 0
            if not live.all():
                parts = parts[live]
            n = len(parts)
            raw_vmax = 1.0
            if n:
                raw_vmax = max(
                    1.0,
                    float(np.abs(parts["vx"]).max(initial=0.0)),
                    float(np.abs(parts["vy"]).max(initial=0.0)),
                )
            # Hysteresis on the quantization scale: a per-frame max makes the
            # scale (and the browser's extrapolated positions) breathe frame
            # to frame. Grow immediately to avoid clipping; shrink only
            # gradually once the peak is well below the scale.
            prev = self._vmax_scale
            if prev is None or raw_vmax > prev:
                vmax = raw_vmax
            elif raw_vmax < 0.5 * prev:
                vmax = max(raw_vmax, prev * 0.75)
            else:
                vmax = prev
            self._vmax_scale = vmax
            body = np.empty(n, dtype=[("x", "<u2"), ("y", "<u2"), ("vx", "<i2"), ("vy", "<i2")])
            body["x"] = (parts["x"] >> np.uint32(16)).astype(np.uint16)
            body["y"] = (parts["y"] >> np.uint32(16)).astype(np.uint16)
            scale = np.float32(32767.0 / vmax)
            body["vx"] = np.clip(parts["vx"] * scale, -32767, 32767).astype(np.int16)
            body["vy"] = np.clip(parts["vy"] * scale, -32767, 32767).astype(np.int16)
            body_bytes = body.tobytes()
            self._bin_cache = (frame, n, vmax, body_bytes)
        header = _BIN_HEADER.pack(
            _BIN_MAGIC, n, float(exact), float(play_time), float(play_speed),
            float(meta.box_width), float(meta.box_height), float(vmax),
            float(meta.species(0).sigma), flags,
        )
        # two buffers, NOT header + body_bytes: the concat would memcpy the
        # ~8 MB cached body on EVERY fetch (~0.5 GB/s of pure copy at the
        # sustained 1M fetch rate); the HTTP handler writes them back-to-back
        return header, body_bytes

    # -- controls -----------------------------------------------------------------
    def _persist_presets(self) -> None:
        """Presets survive restarts when --presets-dir is set: each preset is
        a wire-format .frame file (io/presets.py serialize_dir/write_dir).

        Serialization (a memcpy) happens under self.lock; the disk write —
        multi-second with large presets — happens OUTSIDE it so concurrent
        /frame.bin and /stats polls never block on it. write_dir replaces
        files atomically and cleans stale ones last, so a crash mid-save
        keeps a loadable directory. Callers must NOT hold self.lock."""
        if not self.presets_dir:
            return
        from particle_simulator_tpu_torch.io.presets import Presets

        # _persist_lock serializes whole persists (so concurrent mutations
        # can't interleave tmp files or land an older snapshot last); the
        # state lock is then taken only for the in-memory snapshot, so each
        # queued persist writes the freshest state and disk IO never blocks
        # /frame.bin or /stats
        with self._persist_lock:
            with self.lock:
                payloads = self.editor.presets.serialize_dir()
            try:
                Presets.write_dir(self.presets_dir, payloads)
            except OSError:
                pass

    def control(self, req: dict) -> None:
        e = self.editor
        action = req.get("action")
        persist = False
        with self.lock:
            if action == "toggle_play":
                e.toggle_play()
            elif action == "toggle_loop":
                e.toggle_loop()
            elif action == "seek_live":
                e.seek_live()
            elif action == "lattice":
                # full lattice sub-panel (editor.rs:878-942): size, distance
                # factor, min/max velocity magnitude, species, hex/square
                e.send_lattice(
                    int(req.get("nx", 50)), int(req.get("ny", 50)),
                    distance_factor=float(req.get("distance_factor", 1.1)),
                    velocity=(float(req.get("vmin", 0.0)),
                              float(req.get("vmax", req.get("vmin", 0.0)))),
                    hex_grid=bool(req.get("hex", True)),
                    ty=int(req.get("ty", 0)),
                )
            elif action == "clear":
                e.clear_scene()
            elif action == "clear_timeline":
                e.clear_timeline()  # editor.rs:1299 — frees history RAM only
            elif action == "disconnect":
                e.disconnect()
            elif action == "connect_files":
                # the reference's "Files / Pipes" backend button
                # (editor.rs:839-841, backend.rs:70-105); default paths match
                # it (its read_path/write_path literals), overridable per
                # request. A missing file is a status line, not a 500.
                in_path = str(req.get("in", "./backend_out.bin"))
                out_path = str(req.get("out", "./backend_in.bin"))
                try:
                    e.backend.open_backend_files(in_path, out_path)
                except OSError as err:
                    # a failed connect leaves any live connection untouched
                    # (open_backend_files validates before tearing down);
                    # only surface the error when nothing else is connected
                    if not e.backend.is_connected:
                        e.backend.connection_details = f"files: {err}"
            elif action == "speed":
                e.play_speed = float(req.get("value", e.play_speed))
            elif action == "seek_frac":
                e.seek(float(req.get("value", 1.0)) * e.timeline.sim_len())
            elif action == "seek_frames":
                e.seek_frames(int(req.get("delta", 1)))
            elif action == "edit_begin":
                e.begin_editing()
            elif action == "edit_begin_empty":
                e.begin_editing_empty()
            elif action == "toggle_send_clear":
                e.next_send_and_clear = not e.next_send_and_clear
            elif action == "edit_resend":
                e.resend_current()
            elif action == "edit_cancel":
                e.cancel_editing()
            elif action == "preset_save":
                e.save_preset(str(req.get("name", "preset")))
                persist = True
            elif action == "preset_send":
                i = int(req.get("index", -1))
                if 0 <= i < len(e.presets):
                    e.send_preset(i)
            elif action == "preset_delete":
                i = int(req.get("index", -1))
                if 0 <= i < len(e.presets):
                    e.delete_preset(i)  # keeps an open preset edit's index coherent
                    persist = True
            elif action == "preset_duplicate":
                i = int(req.get("index", -1))
                if 0 <= i < len(e.presets):
                    e.duplicate_preset(i)
                    persist = True
            elif action == "preset_edit":
                i = int(req.get("index", -1))
                if 0 <= i < len(e.presets):
                    e.edit_preset(i)
            elif action == "preset_update":
                name = req.get("name")
                e.update_preset(None if not name else str(name))
                persist = True
            elif action == "preset_rename":
                i = int(req.get("index", -1))
                if 0 <= i < len(e.presets) and req.get("name"):
                    e.rename_preset(i, str(req["name"]))
                    persist = True
        if persist:
            self._persist_presets()  # re-locks briefly; disk write unlocked

    def tool(self, req: dict) -> dict:
        """Apply a drawing-tool stroke (editor.rs:1443-1607 toolbar semantics).

        Request: tool (brush/eraser/speed/clear), points (normalized [0,1]
        canvas coords), width_cells/height_cells (stroke footprint in lattice
        cells), lattice (hex/square), velocity (m/s), angle (radians or null
        = random), ty (species), distance_factor.

        Unknown tool/lattice names are rejected with an ``error`` payload
        rather than a 500 (mirrors the engine's tolerance of garbage enum
        bytes in update_metadata)."""
        try:
            tool = Tool(str(req.get("tool", "brush")))
            kind = LatticeKind(str(req.get("lattice", "hex")))
        except ValueError as e:
            return {"error": str(e)}
        with self.lock:
            e = self.editor
            if not e.editing:
                e.begin_editing()
            frame = e._edit_frame
            meta = frame.metadata
            angle = req.get("angle")
            options = ToolOptions(
                tool=tool,
                distance_factor=float(req.get("distance_factor", 1.0)),
                lattice=kind,
                velocity=float(req.get("velocity", 0.0)),
                angle=None if angle is None else float(angle),
                ty=int(req.get("ty", 0)),
            )
            rx, ry = lattice_resolution(frame, options)
            points = [
                (float(p[0]) * meta.box_width, float(p[1]) * meta.box_height)
                for p in req.get("points", [])
            ]
            stroke = Stroke(
                points=points,
                width=float(req.get("width_cells", 6.0)) * rx,
                height=float(req.get("height_cells", 6.0)) * ry,
            )
            affected = e.apply_tool(stroke, options, rng=self._rng)
            return {"affected": affected, "count": frame.particle_count}

    def params(self, req: dict) -> None:
        """Full parameters-panel surface (editor.rs:828-1411): scalars, the
        per-species Mie sliders (``sigma0``..``m1``), and the enum selectors."""
        with self.lock:
            sp = self.editor.sim_params
            for name, value in req.items():
                if name in ("step_dt", "cursor_size", "box_width", "box_height"):
                    sp[name] = float(value)
                elif name in ("steps_per_frame", "data_structure", "device",
                              "gpu_threads_per_block_log2"):
                    sp[name] = int(value)
                elif len(name) > 1 and name[:-1] in ("sigma", "epsilon", "n", "m") \
                        and name[-1] in "01":
                    sp["particles"][int(name[-1])][name[:-1]] = float(value)

    def cursor(self, req: dict) -> None:
        with self.lock:
            self.editor.cursor_move(
                float(req.get("x", -1)), float(req.get("y", -1)), bool(req.get("down"))
            )

    def presets_list(self) -> list:
        with self.lock:
            return [
                {"name": p.name, "count": int(len(p.particles))}
                for p in self.editor.presets
            ]

    def stats(self) -> dict:
        with self.lock:
            st = self.editor.stats()
            st["editing"] = self.editor.editing
            st["loop"] = self.editor.loop
            st["send_clear"] = self.editor.next_send_and_clear
            st["presets"] = len(self.editor.presets)
            st["selftest"] = self.selftest
            # cursor-force radius as a BOX FRACTION for the local stroke ring
            # (metadata cursor_size is already normalized, physics/mie.py:192)
            st["cursor_frac"] = float(self.editor.sim_params["cursor_size"])
            # ghost of the engine's active cursor (editor.rs:423-431): the
            # engine echoes cursor_pos in every outbound frame's metadata
            frame, _ = self.editor.display_frame()
            if frame is not None:
                cx, cy = (float(v) for v in frame.metadata.cursor_pos)
                st["engine_cursor"] = {"x": cx, "y": cy, "size": float(frame.metadata.cursor_size)}
                # lattice cell size as a BOX FRACTION for the brush footprint
                # overlay (the client scales by its own canvas size)
                rx, ry = lattice_resolution(frame, ToolOptions())
                meta = frame.metadata
                st["cell_frac"] = {
                    "x": rx / meta.box_width,
                    "y": ry / meta.box_height,
                }
            return st

    def close(self):
        self._stop = True
        self.editor.backend.close()


def _png_bytes(img: np.ndarray) -> bytes:
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 3))
        + chunk(b"IEND", b"")
    )


def make_server(http_addr, web: WebEditor) -> ThreadingHTTPServer:
    page = render_page().encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, body, ctype: str):
            """body: bytes, or a tuple of buffers written back-to-back
            (zero-concat path for the big /frame.bin payloads)."""
            parts = body if isinstance(body, tuple) else (body,)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(sum(len(b) for b in parts)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            for b in parts:
                self.wfile.write(b)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/":
                self._send(200, page, "text/html")
            elif path == "/frame.png":
                self._send(200, web.frame_png(), "image/png")
            elif path == "/frame.bin":
                self._send(200, web.frame_bin(), "application/octet-stream")
            elif path == "/presets":
                self._send(200, json.dumps(web.presets_list()).encode(), "application/json")
            elif path == "/stats":
                self._send(200, json.dumps(web.stats()).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                req = {}
            path = urlparse(self.path).path
            out = {}
            if path == "/control":
                web.control(req)
            elif path == "/params":
                web.params(req)
            elif path == "/cursor":
                web.cursor(req)
            elif path == "/tool":
                out = web.tool(req)
            elif path == "/selftest":
                web.selftest = {
                    "total": int(req.get("total", 0)),
                    "failed": int(req.get("failed", 0)),
                    "failures": [str(s) for s in req.get("failures", [])][:20],
                }
            self._send(200, json.dumps(out).encode(), "application/json")

    return ThreadingHTTPServer(http_addr, Handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--http", default="127.0.0.1:8700", help="UI listen address")
    ap.add_argument(
        "--addr",
        default="127.0.0.1:53123",
        help="engine TCP listen address (pass 0.0.0.0:PORT to accept remote engines)",
    )
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--presets-dir", default=None,
                    help="persist presets as .frame files in this directory "
                         "(loaded at startup, saved on every change)")
    args = ap.parse_args(argv)

    h, p = args.http.rsplit(":", 1)
    eh, ep = args.addr.rsplit(":", 1)
    web = WebEditor(backend_addr=(eh, int(ep)), size=args.size,
                    presets_dir=args.presets_dir)
    server = make_server((h, int(p)), web)
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        print(f"editor UI: http://{h}:{p}  (engine port {ep})", file=sys.stderr)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        web.close()
        server.server_close()
        report_foreign_modules("editor UI")
    return 0


def _interrupt(signum, frame):
    """SIGTERM stops the server the way Ctrl-C does."""
    raise KeyboardInterrupt


if __name__ == "__main__":
    sys.exit(main())
