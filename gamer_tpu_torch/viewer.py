"""Interactive galaxy viewer and editor, the counterpart of
``gamer_tpu.viewer``: a standard-library HTTP server that serves a
single-page editor (the reference's Qt editor, source/mainwindow.cpp, and
its realtime viewer, tools/galaxy_viewer.py:102-211, for a machine without
a display). Every interaction re-renders through the port's kernels on
``device`` (the card unless the caller asks for the CPU):

    /render        ``cuda_render.render_scene`` at a noise LOD (K1)
    /fullrender    ``cuda_render.render_progressive`` in 16 row bands (K5);
                   with &stream=1 each band is pushed as a
                   multipart/x-mixed-replace part, so the frame paints as
                   the reference GUI's 50 ms partial-frame loop does
                   (mainwindow.cpp:581-644)
    /skybox        ``batch.render_batch`` of the six cube faces in one
                   launch (K4), returned as a 3x2 montage
                   (renderqueue.cpp:129-173)

    python -m gamer_tpu_torch.viewer [--port 8000] [--size 256] [--dir <gax dir>]
                                     [--device cuda|cpu]

Endpoints (GET unless noted):
    /                  editor page (orbit + the five tabs)
    /render?...        preview PNG: galaxy=<name>&h=<deg>&v=<deg>&zoom=<f>
                       &lod=<octave cap>&ss=<supersample>
    /galaxies          JSON list of available galaxies (files + presets)
    /params?galaxy=    JSON dict of the galaxy's current (edited) parameters
    /set?galaxy=&comp=&field=&value=   live parameter edit; the next /render
                       shows it. comp=-1 edits galaxy-level params.
    /addcomp?galaxy=&class=     append a component of the given class
    /delcomp?galaxy=&comp=      remove a component
    /clonecomp?galaxy=&comp=    duplicate a component
    /spectra           JSON {name: [r,g,b]} of the session spectra table
    /setspectrum?name=&value=r,g,b    add/update a named spectrum
    /delspectrum?name=          remove a user spectrum
    /cfg               JSON of the session render settings
    /setcfg?field=&value=       edit a render setting (exposure, gamma,
                                saturation, ray_step, fov, star field, dither)
    /save?galaxy=      download the edited galaxy as .gax bytes
    /newgalaxy?name=   add a galaxy from the default template
    /clonegalaxy?galaxy=&name=   duplicate a galaxy (with its live edits);
                       empty name auto-suffixes _copy
    /delgalaxy?galaxy= remove a galaxy from the library (not the last one)
    POST /upload?name= add a galaxy from .gax bytes in the request body
    /fullrender?galaxy=&size=&h=&v=&zoom=&ss=&bands=&stream=   full-quality
                       render (exact octaves, full min step, configured
                       ray_step)
    /skybox?galaxy=&size=       the six cube faces as one PNG
    /reset?galaxy=     drop all edits for the galaxy

Bad input answers 400 (a ValueError or KeyError), any other failure 500,
an unknown path 404. One render runs at a time (the state's lock): the
handler threads share the card. PNGs are written by ``io.png.encode_png``.
"""

from __future__ import annotations

import copy
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from .engine import batch, cuda_render
from .engine.queue import skybox_jobs
from .io.png import encode_png
from .models.presets import FIXTURE_DIR, GALLERY
from .scene import gax
from .scene.cameracontrols import rotate_horizontal, rotate_vertical
from .scene.cameracontrols import zoom as czoom
from .scene.schema import (
    CameraParams,
    ComponentParams,
    GalaxyInstance,
    RenderConfig,
    Scene,
    default_galaxy,
    galaxy_to_dict,
)
from .scene.spectra import BUILTIN_SPECTRA

_PAGE = """<!doctype html>
<title>gamer-tpu editor</title>
<style>
body{background:#000;color:#ccc;font-family:monospace;margin:8px}
#main{display:flex;gap:12px;align-items:flex-start}
#left{text-align:center}
img#v{image-rendering:pixelated;width:62vmin;height:62vmin}
#panel{flex:1;min-width:420px;max-width:760px}
button{background:#222;color:#ccc;border:1px solid #555;margin:2px;padding:3px 9px;cursor:pointer}
button.tab.on{background:#444;color:#fff}
input,select{background:#111;color:#ccc;border:1px solid #444;width:5.5em}
input[type=checkbox]{width:auto}
table{border-collapse:collapse;font-size:12px}
td,th{border:1px solid #333;padding:2px 5px;text-align:left}
th{color:#8ad}
.dim{color:#777}
#status{color:#8ad;min-height:1.2em}
</style>
<h3 style="margin:4px 0">gamer-tpu editor ::
 <select id=gsel onchange="pick()"></select>
 <button onclick="newGalaxy()">new</button>
 <button onclick="cloneGalaxy()">clone</button>
 <button onclick="delGalaxy()">delete</button>
 <button onclick="saveGax()">save .gax</button>
 <button onclick="fullRender()">render</button>
 <button onclick="skybox()">skybox</button>
 <button onclick="resetEdits()">reset edits</button>
 <span id=status></span></h3>
<div id=main>
<div id=left>
<img id=v>
<div>
<button onclick="rot(-15,0)">&larr;</button>
<button onclick="rot(15,0)">&rarr;</button>
<button onclick="rot(0,-15)">&uarr;</button>
<button onclick="rot(0,15)">&darr;</button>
<button onclick="zoomBy(0.1)">zoom+</button>
<button onclick="zoomBy(-0.1)">zoom-</button>
<button id=q onclick="cycleLod()">quality: fast</button>
</div>
<div class=dim>drag to orbit &middot; wheel zooms &middot; a/d w/s q/e n f</div>
</div>
<div id=panel>
<div>
<button class="tab on" id=tb_comp onclick="tab('comp')">Components</button>
<button class=tab id=tb_gal onclick="tab('gal')">Galaxy</button>
<button class=tab id=tb_spec onclick="tab('spec')">Spectra</button>
<button class=tab id=tb_rend onclick="tab('rend')">Rendering</button>
</div>
<div id=body></div>
</div>
</div>
<script>
let h=0,v=20,zoom=0,names=[],cur='',params=null,spectra={},cfg={},
  quals=[[4,1],[6,1],[0,1],[0,2]],qualNames=['fast','med','exact','exact+AA'],
  li=0,curTab='comp';
const CF=['strength','arm','z0','r0','inner','delta','winding','scale',
  'noise_offset','noise_tilt','ks'];
const GF=['winding_b','winding_n','no_arms','arm1','arm2','arm3','arm4',
  'bulge_dust','inner_twirl','warp_amplitude','warp_scale'];
const RF=['exposure','gamma','saturation','ray_step','fov','no_stars',
  'star_size','star_size_spread','star_strength','star_seed'];
const CLASSES=['bulge','disk','dust','dust2','dust positive','stars','stars small'];
function S(m){document.getElementById('status').textContent=m||'';}
async function J(u){const r=await fetch(u);if(!r.ok){S(await r.text());throw 0;}
  S('');return r.json();}
async function load(){names=await J('/galaxies');cur=names[0]||'';
  const s=document.getElementById('gsel');
  s.innerHTML=names.map(n=>'<option>'+n+'</option>').join('');
  await pull();refresh();}
async function pull(){params=await J('/params?galaxy='+encodeURIComponent(cur));
  spectra=await J('/spectra');cfg=await J('/cfg');panel();}
function pick(){cur=document.getElementById('gsel').value;h=0;v=20;zoom=0;
  pull().then(refresh);}
function refresh(){
  document.getElementById('v').src='/render?galaxy='+encodeURIComponent(cur)+
    '&h='+h+'&v='+v+'&zoom='+zoom+'&lod='+quals[li][0]+'&ss='+quals[li][1]+
    '&_='+Date.now();}
function cycleLod(){li=(li+1)%quals.length;
  document.getElementById('q').textContent='quality: '+qualNames[li];refresh();}
function rot(dh,dv){h+=dh;v+=dv;refresh();}
function zoomBy(d){zoom=+(zoom+d).toFixed(3);refresh();}
function cycle(d){const i=(names.indexOf(cur)+d+names.length)%names.length;
  cur=names[i];document.getElementById('gsel').value=cur;pull().then(refresh);}
function tab(t){curTab=t;
  for(const x of['comp','gal','spec','rend'])
    document.getElementById('tb_'+x).classList.toggle('on',x==t);
  panel();}
async function setP(comp,field,value){
  await J('/set?galaxy='+encodeURIComponent(cur)+'&comp='+comp+
    '&field='+encodeURIComponent(field)+'&value='+encodeURIComponent(value));
  await pull();refresh();}
function panel(){
  const B=document.getElementById('body');
  if(!params){B.innerHTML='';return;}
  if(curTab=='comp'){
    const specOpts=n=>Object.keys(spectra).map(s=>'<option'+
      (s.toLowerCase()==n.toLowerCase()?' selected':'')+'>'+s+'</option>').join('');
    let rows=params.components.map((c,i)=>'<tr><td>'+i+'<br><span class=dim>'+
      c.class_name+'</span></td>'+
      '<td><input type=checkbox '+(c.active==1?'checked':'')+
      ' onchange="setP('+i+',\\'active\\',this.checked?1:0)">'+
      '<select onchange="setP('+i+',\\'spectrum\\',this.value)">'+
      specOpts(c.spectrum)+'</select><br>'+
      '<button onclick="cloneComp('+i+')">clone</button>'+
      '<button onclick="delComp('+i+')">del</button></td>'+
      CF.map(f=>'<td><input type=number step=any value="'+c[f]+
        '" onchange="setP('+i+',\\''+f+'\\',this.value)"></td>').join('')+
      '</tr>').join('');
    B.innerHTML='<table><tr><th>#</th><th>on/spec</th>'+
      CF.map(f=>'<th>'+f+'</th>').join('')+'</tr>'+rows+'</table>'+
      '<p><select id=newclass>'+CLASSES.map(c=>'<option>'+c+'</option>').join('')+
      '</select> <button onclick="addComp()">add component</button></p>';
  }else if(curTab=='gal'){
    const p=params.params;
    B.innerHTML='<table>'+GF.map(f=>'<tr><th>'+f+'</th>'+
      '<td><input type=number step=any value="'+p[f]+
      '" onchange="setP(-1,\\''+f+'\\',this.value)"></td></tr>').join('')+
      '<tr><th>axis</th><td>'+[0,1,2].map(k=>'<input type=number step=any '+
      'id=ax'+k+' value="'+p.axis[k]+'" onchange="setAxis()">').join(' ')+
      '</td></tr></table>';
  }else if(curTab=='spec'){
    B.innerHTML='<table><tr><th>name</th><th>r</th><th>g</th><th>b</th><th></th></tr>'+
      Object.entries(spectra).map(([n,rgb])=>'<tr><td>'+n+'</td>'+
        [0,1,2].map(k=>'<td><input type=number step=any min=0 max=1 value="'+
          rgb[k]+'" onchange="setSpec(\\''+n+'\\','+k+',this.value)"></td>').join('')+
        '<td><button onclick="delSpec(\\''+n+'\\')">del</button></td></tr>').join('')+
      '</table><p><input id=newspec placeholder=name style="width:8em">'+
      ' <button onclick="addSpec()">add spectrum</button></p>';
  }else{
    B.innerHTML='<table>'+RF.map(f=>'<tr><th>'+f+'</th>'+
      '<td><input type=number step=any value="'+cfg[f]+
      '" onchange="setCfg(\\''+f+'\\',this.value)"></td></tr>').join('')+
      '<tr><th>dither</th><td><input type=checkbox '+(cfg.dither?'checked':'')+
      ' onchange="setCfg(\\'dither\\',this.checked?1:0)"></td></tr></table>'+
      '<p class=dim>preview marches at rayStep 0.025 like the reference '+
      'preview; ray_step applies to the render button.</p>';
  }
}
async function setAxis(){
  const v=[0,1,2].map(k=>document.getElementById('ax'+k).value).join(',');
  await setP(-1,'axis',v);}
async function addComp(){
  await J('/addcomp?galaxy='+encodeURIComponent(cur)+'&class='+
    encodeURIComponent(document.getElementById('newclass').value));
  await pull();refresh();}
async function delComp(i){await J('/delcomp?galaxy='+encodeURIComponent(cur)+
  '&comp='+i);await pull();refresh();}
async function cloneComp(i){await J('/clonecomp?galaxy='+encodeURIComponent(cur)+
  '&comp='+i);await pull();refresh();}
async function setSpec(n,k,v){const rgb=spectra[n].slice();rgb[k]=+v;
  await J('/setspectrum?name='+encodeURIComponent(n)+'&value='+rgb.join(','));
  await pull();refresh();}
async function addSpec(){const n=document.getElementById('newspec').value.trim();
  if(!n)return;await J('/setspectrum?name='+encodeURIComponent(n)+'&value=1,1,1');
  await pull();}
async function delSpec(n){await J('/delspectrum?name='+encodeURIComponent(n));
  await pull();refresh();}
async function setCfg(f,v){await J('/setcfg?field='+encodeURIComponent(f)+
  '&value='+encodeURIComponent(v));await pull();refresh();}
function saveGax(){location.href='/save?galaxy='+encodeURIComponent(cur);}
async function newGalaxy(){const n=prompt('new galaxy name');if(!n)return;
  const r=await J('/newgalaxy?name='+encodeURIComponent(n));
  names=await J('/galaxies');
  document.getElementById('gsel').innerHTML=
    names.map(x=>'<option>'+x+'</option>').join('');
  cur=r.galaxy;document.getElementById('gsel').value=cur;
  await pull();refresh();}
async function cloneGalaxy(){
  const n=prompt('clone as (empty = auto name)','')||'';
  const r=await J('/clonegalaxy?galaxy='+encodeURIComponent(cur)+
    '&name='+encodeURIComponent(n));
  names=await J('/galaxies');
  document.getElementById('gsel').innerHTML=
    names.map(x=>'<option>'+x+'</option>').join('');
  cur=r.galaxy;document.getElementById('gsel').value=cur;
  await pull();refresh();}
async function delGalaxy(){
  if(!confirm('delete galaxy "'+cur+'" from the library?'))return;
  await J('/delgalaxy?galaxy='+encodeURIComponent(cur));await load();}
function fullRender(){S('rendering...');
  const s=prompt('full render size',cfg.full_size||512);if(!s)return S('');
  window.open('/fullrender?galaxy='+encodeURIComponent(cur)+'&size='+s+
    '&h='+h+'&v='+v+'&zoom='+zoom+'&stream=1','_blank');S('');}
function skybox(){window.open('/skybox?galaxy='+encodeURIComponent(cur),'_blank');}
async function resetEdits(){
  await fetch('/reset?galaxy='+encodeURIComponent(cur));await pull();refresh();}
document.addEventListener('keydown',e=>{
  if(e.target.tagName=='INPUT'||e.target.tagName=='SELECT')return;
  if(e.key=='a')rot(-15,0); if(e.key=='d')rot(15,0);
  if(e.key=='w')rot(0,-15); if(e.key=='s')rot(0,15);
  if(e.key=='q')zoomBy(0.1); if(e.key=='e')zoomBy(-0.1);
  if(e.key=='n')cycle(1); if(e.key=='f')cycleLod();});
let drag=null;
const img=document.getElementById('v');
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];e.preventDefault();});
window.addEventListener('pointerup',e=>{
  if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=null;
  if(Math.abs(dx)+Math.abs(dy)>3)rot(Math.round(dx/3),Math.round(dy/3));});
img.addEventListener('wheel',e=>{e.preventDefault();zoomBy(e.deltaY<0?0.1:-0.1);},
  {passive:false});
load();
</script>"""


# numeric knobs editable through /set: the ComponentParams / GalaxyParams
# fields of the reference's Components and Galaxy tabs (componentparams.h:
# 7-44, galaxyparams.h:10-43). 'active' toggles a component (a new scene
# structure, like the GUI's checkbox); 'spectrum' and 'name' are strings.
_COMP_EDIT_FIELDS = {
    "strength", "arm", "z0", "r0", "inner", "delta", "winding", "scale",
    "noise_offset", "noise_tilt", "ks", "active",
}
_GALAXY_EDIT_FIELDS = {
    "winding_b", "winding_n", "no_arms", "arm1", "arm2", "arm3", "arm4",
    "bulge_dust", "inner_twirl", "warp_amplitude", "warp_scale",
}
# session render settings (Rendering/PostProcessing tab fields,
# renderingparams.h:19-39), floats unless listed as ints
_CFG_FIELDS = {
    "exposure", "gamma", "saturation", "ray_step", "fov", "star_size",
    "star_size_spread", "star_strength",
}
_CFG_INT_FIELDS = {"no_stars", "star_seed", "dither", "full_size"}

_FULLRENDER_MAX = 2048  # bounds the work of one /fullrender
_VALID_CLASSES = (
    "bulge", "disk", "dust", "dust2", "dust positive", "stars", "stars small",
)


class _ViewerState:
    """The editor's session: the galaxy library (files of ``gax_dir`` and
    the presets), each edited galaxy as a materialised copy, the session
    spectra table and render settings, and the lock that lets one render
    run at a time on ``device``."""

    def __init__(self, size: int, gax_dir: Path | None, device="cuda"):
        # no card, no viewer: nothing falls back to the CPU on its own
        self.device = cuda_render._device(device)
        self.size = size
        self.lock = threading.Lock()
        self.galaxies = {}
        # name -> the edited copy (materialised, not an edit log, so that
        # structural edits compose, as the GUI mutates its live Galaxy)
        self.edited: dict = {}
        self.spectra = {k.capitalize(): tuple(v)
                        for k, v in BUILTIN_SPECTRA.items()}
        self.cfg = {
            "exposure": 1.0, "gamma": 1.0, "saturation": 1.0,
            "ray_step": 0.025, "fov": 75.0, "no_stars": 0,
            "star_size": 1.0, "star_size_spread": 1.0, "star_strength": 1.0,
            "star_seed": 0, "dither": 0, "full_size": 512,
        }
        if gax_dir and gax_dir.is_dir():
            for p in sorted(gax_dir.glob("*.gax")):
                self.galaxies[p.stem] = lambda p=p: gax.load(p)
        for name, make in GALLERY.items():
            self.galaxies.setdefault(name, make)

    def _resolve(self, name: str) -> str:
        """The galaxy's key: an empty name is the first entry; an unknown
        name is an error, never another galaxy's data."""
        if not name:
            return next(iter(self.galaxies))
        if name not in self.galaxies:
            raise ValueError(f"unknown galaxy {name!r}")
        return name

    def _galaxy(self, name: str):
        """The named galaxy with this session's edits."""
        key = self._resolve(name)
        if key in self.edited:
            return self.edited[key]
        return self.galaxies[key]()

    def _materialize(self, name: str):
        key = self._resolve(name)
        if key not in self.edited:
            self.edited[key] = copy.deepcopy(self.galaxies[key]())
        return self.edited[key]

    def set_param(self, name: str, comp: int, field: str, raw: str):
        """Validate and apply one edit; returns the applied value."""
        g = self._materialize(name)
        if comp < 0:  # galaxy-level
            if field == "axis":
                value = tuple(float(v) for v in raw.split(","))
                if len(value) != 3:
                    raise ValueError("axis needs 3 comma-separated values")
            elif field == "name":
                value = raw
                g.display_name = raw
                g.params.name = raw
                return value
            elif field in _GALAXY_EDIT_FIELDS:
                value = float(raw)
            else:
                raise ValueError(
                    f"unknown galaxy field {field!r}; editable: "
                    f"{sorted(_GALAXY_EDIT_FIELDS)} + axis, name")
            setattr(g.params, field, value)
        else:
            if not 0 <= comp < len(g.components):
                raise ValueError(
                    f"component {comp} out of range (galaxy has "
                    f"{len(g.components)})")
            if field in ("spectrum", "name"):
                value = raw
            elif field in _COMP_EDIT_FIELDS:
                value = int(float(raw)) if field == "active" else float(raw)
            else:
                raise ValueError(
                    f"unknown component field {field!r}; editable: "
                    f"{sorted(_COMP_EDIT_FIELDS)} + spectrum, name")
            setattr(g.components[comp], field, value)
        return value

    # -- structural component edits (the GUI's add, clone and delete
    # buttons, mainwindow.cpp:846-927, 653-664) --

    def add_component(self, name: str, class_name: str):
        if class_name.lower() not in _VALID_CLASSES:
            raise ValueError(
                f"unknown component class {class_name!r}; one of "
                f"{list(_VALID_CLASSES)}")
        g = self._materialize(name)
        g.components.append(ComponentParams(class_name=class_name.lower(),
                                            name=f"New {class_name}"))
        return len(g.components) - 1

    def del_component(self, name: str, comp: int):
        g = self._materialize(name)
        if not 0 <= comp < len(g.components):
            raise ValueError(f"component {comp} out of range")
        g.components.pop(comp)

    def clone_component(self, name: str, comp: int):
        g = self._materialize(name)
        if not 0 <= comp < len(g.components):
            raise ValueError(f"component {comp} out of range")
        g.components.insert(comp + 1, copy.deepcopy(g.components[comp]))
        return comp + 1

    # -- the spectra table (Spectra tab, spectrum.h:74-93) --

    def set_spectrum(self, name: str, raw: str):
        if not name:
            raise ValueError("spectrum needs a name")
        rgb = tuple(float(v) for v in raw.split(","))
        if len(rgb) != 3:
            raise ValueError("spectrum value needs 3 comma-separated floats")
        self.spectra[name] = rgb
        return rgb

    def del_spectrum(self, name: str):
        if name not in self.spectra:
            raise ValueError(f"unknown spectrum {name!r}")
        del self.spectra[name]

    # -- render settings (Rendering/PostProcessing tabs) --

    def set_cfg(self, field: str, raw: str):
        if field in _CFG_INT_FIELDS:
            value = int(float(raw))
        elif field in _CFG_FIELDS:
            value = float(raw)
        else:
            raise ValueError(
                f"unknown setting {field!r}; editable: "
                f"{sorted(_CFG_FIELDS | _CFG_INT_FIELDS)}")
        if field == "ray_step" and not value > 0:
            raise ValueError("ray_step must be > 0")
        if field == "full_size" and not 8 <= value <= _FULLRENDER_MAX:
            raise ValueError(f"full_size must be in [8, {_FULLRENDER_MAX}]")
        self.cfg[field] = value
        return value

    # -- the galaxy library (new, clone, delete; mainwindow.cpp:846-927) --

    def _register(self, name: str, galaxy) -> str:
        if not name:
            raise ValueError("galaxy needs a non-empty name")
        if name in self.galaxies:
            raise ValueError(f"galaxy {name!r} already exists")
        galaxy.display_name = name
        galaxy.params.name = name
        self.galaxies[name] = lambda galaxy=galaxy: copy.deepcopy(galaxy)
        return name

    def new_galaxy(self, name: str) -> str:
        """A galaxy from the default 3-component template
        (galaxy.cpp:111-154)."""
        return self._register(name, default_galaxy())

    def clone_galaxy(self, src: str, new_name: str) -> str:
        """A copy of a galaxy with its live edits (the GUI clones its live
        Galaxy object, mainwindow.cpp:905-914)."""
        key = self._resolve(src)
        if not new_name:
            new_name = f"{key}_copy"
            n = 2
            while new_name in self.galaxies:
                new_name = f"{key}_copy{n}"
                n += 1
        return self._register(new_name, copy.deepcopy(self._galaxy(key)))

    def delete_galaxy(self, name: str) -> None:
        key = self._resolve(name)
        if len(self.galaxies) <= 1:
            raise ValueError("cannot delete the last galaxy in the library")
        del self.galaxies[key]
        self.edited.pop(key, None)

    def add_galaxy_bytes(self, name: str, data: bytes):
        if not name:
            raise ValueError("upload needs a ?name=")
        galaxy = gax.loads(data)  # validates before registering
        self.galaxies[name] = lambda galaxy=galaxy: copy.deepcopy(galaxy)
        self.edited.pop(name, None)

    def gax_bytes(self, name: str) -> bytes:
        return gax.dumps(self._galaxy(name))

    # -- rendering --

    def _scene(self, name: str, h_deg: float, v_deg: float, zoom: float,
               size: int, preview: bool, lod: int = 0, ss: int = 1) -> Scene:
        """The scene of one view: the camera at (1.2, 0, 0) looking at the
        origin with z up, turned by h and v degrees and zoomed; the preview
        marches at ray step 0.025 (mainwindow.cpp:483-495), a full render
        at the configured step."""
        galaxy = self._galaxy(name)
        cam = CameraParams(camera=(1.2, 0.0, 0.0), target=(0, 0, 0),
                           up=(0, 0, 1), fov=self.cfg["fov"])
        cam = rotate_horizontal(cam, h_deg)
        cam = rotate_vertical(cam, v_deg)
        if zoom:
            cam = czoom(cam, zoom)
        c = self.cfg
        config = RenderConfig(
            size=size,
            ray_step=0.025 if preview else c["ray_step"],
            is_preview=preview,
            exposure=c["exposure"], gamma=c["gamma"],
            saturation=c["saturation"],
            no_stars=c["no_stars"], star_size=c["star_size"],
            star_size_spread=c["star_size_spread"],
            star_strength=c["star_strength"], star_seed=c["star_seed"],
            dither=bool(c["dither"]),
            noise_octaves=lod or None,
            supersample=max(1, ss),
        )
        return Scene(camera=cam, instances=[GalaxyInstance(galaxy=galaxy)],
                     config=config, spectra=dict(self.spectra))

    def render_png(self, name: str, h_deg: float, v_deg: float,
                   zoom: float, lod: int = 4, ss: int = 1) -> bytes:
        """The preview: noise LOD 4 by default (preview-grade grain);
        lod=0 renders the exact octave counts."""
        scene = self._scene(name, h_deg, v_deg, zoom, self.size,
                            preview=True, lod=lod, ss=ss)
        with self.lock:  # one render at a time
            img = cuda_render.render_scene(scene, device=self.device)
        return encode_png(img)

    def fullrender_png(self, name: str, size: int, h_deg: float,
                       v_deg: float, zoom: float, ss: int = 1) -> bytes:
        """The GUI's Render button: full quality at the requested size."""
        if not 8 <= size <= _FULLRENDER_MAX:
            raise ValueError(f"size must be in [8, {_FULLRENDER_MAX}]")
        scene = self._scene(name, h_deg, v_deg, zoom, size,
                            preview=False, lod=0, ss=ss)
        with self.lock:
            img = cuda_render.render_progressive(scene, device=self.device)
        return encode_png(img)

    def fullrender_progressive(self, name: str, size: int, h_deg: float,
                               v_deg: float, zoom: float, ss: int,
                               emit, bands: int = 16) -> None:
        """The Render button's frame as it fills: one ``emit(frac,
        png_bytes)`` per finished row band, each a whole-frame PNG with the
        rows not yet rendered black; the last part is the finished frame.
        An OSError from emit (the client hung up) aborts the render between
        bands."""
        if not 8 <= size <= _FULLRENDER_MAX:
            raise ValueError(f"size must be in [8, {_FULLRENDER_MAX}]")
        scene = self._scene(name, h_deg, v_deg, zoom, size,
                            preview=False, lod=0, ss=ss)

        def on_progress(frac, partial):
            try:
                emit(frac, encode_png(partial))
            except OSError:
                return False  # the client disconnected: stop rendering
            return True

        with self.lock:
            cuda_render.render_progressive(scene, bands=bands,
                                           on_progress=on_progress,
                                           device=self.device)

    def skybox_png(self, name: str, size: int) -> bytes:
        """The six cube faces in one batched launch, tiled 3x2 (face order
        Z- Z+ Y- / Y+ X- X+, renderqueue.cpp:129-173)."""
        if not 8 <= size <= 512:
            raise ValueError("skybox face size must be in [8, 512]")
        scene = self._scene(name, 0.0, 0.0, 0.0, size, preview=False)
        jobs = skybox_jobs(scene)
        with self.lock:
            frames = batch.render_batch([j.scene for j in jobs],
                                        device=self.device)
        montage = np.zeros((2 * size, 3 * size, 3), np.uint8)
        for i, f in enumerate(frames):
            r, c = divmod(i, 3)
            montage[r * size:(r + 1) * size, c * size:(c + 1) * size] = f
        return encode_png(montage)


def make_handler(state: _ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, "application/json", json.dumps(obj).encode())

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/upload":
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    state.add_galaxy_bytes(q.get("name", [""])[0],
                                           self.rfile.read(n))
                    self._json({"ok": True})
                except Exception as e:  # noqa: BLE001 - the client's error
                    self._send(400, "text/plain", str(e).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)

            def qs(k, d=""):
                return q.get(k, [d])[0]

            def get(k, d):
                return float(q.get(k, [d])[0])

            name = qs("galaxy")
            try:
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/galaxies":
                    self._json(sorted(state.galaxies))
                elif url.path == "/render":
                    png = state.render_png(name, get("h", 0), get("v", 0),
                                           get("zoom", 0),
                                           int(get("lod", 4)),
                                           int(get("ss", 1)))
                    self._send(200, "image/png", png)
                elif url.path == "/params":
                    self._json(galaxy_to_dict(state._galaxy(name)))
                elif url.path == "/set":
                    comp = int(qs("comp", "-1"))
                    field = qs("field")
                    value = state.set_param(name, comp, field, qs("value"))
                    self._json({"galaxy": name, "comp": comp, "field": field,
                                "value": value})
                elif url.path == "/addcomp":
                    idx = state.add_component(name, qs("class", "disk"))
                    self._json({"added": idx})
                elif url.path == "/delcomp":
                    state.del_component(name, int(qs("comp", "-1")))
                    self._json({"ok": True})
                elif url.path == "/clonecomp":
                    idx = state.clone_component(name, int(qs("comp", "-1")))
                    self._json({"added": idx})
                elif url.path == "/spectra":
                    self._json({k: list(v) for k, v in state.spectra.items()})
                elif url.path == "/setspectrum":
                    rgb = state.set_spectrum(qs("name"), qs("value"))
                    self._json({"name": qs("name"), "value": list(rgb)})
                elif url.path == "/delspectrum":
                    state.del_spectrum(qs("name"))
                    self._json({"ok": True})
                elif url.path == "/cfg":
                    self._json(state.cfg)
                elif url.path == "/setcfg":
                    value = state.set_cfg(qs("field"), qs("value"))
                    self._json({"field": qs("field"), "value": value})
                elif url.path == "/save":
                    data = state.gax_bytes(name)
                    fname = (name or "galaxy") + ".gax"
                    self._send(200, "application/octet-stream", data,
                               extra=(("Content-Disposition",
                                       f'attachment; filename="{fname}"'),))
                elif url.path == "/fullrender":
                    if qs("stream"):
                        # multipart/x-mixed-replace: the browser repaints
                        # each part in place, band by band
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "multipart/x-mixed-replace; boundary=gamerband")
                        self.end_headers()

                        def emit(frac, png):
                            self.wfile.write(
                                b"--gamerband\r\n"
                                b"Content-Type: image/png\r\n"
                                + f"Content-Length: {len(png)}\r\n"
                                  f"X-Progress: {frac:.4f}\r\n\r\n".encode())
                            self.wfile.write(png)
                            self.wfile.write(b"\r\n")
                            self.wfile.flush()

                        state.fullrender_progressive(
                            name, int(get("size", state.cfg["full_size"])),
                            get("h", 0), get("v", 0), get("zoom", 0),
                            int(get("ss", 1)), emit,
                            bands=int(get("bands", 16)))
                        try:
                            self.wfile.write(b"--gamerband--\r\n")
                        except OSError:
                            pass
                    else:
                        png = state.fullrender_png(
                            name, int(get("size", state.cfg["full_size"])),
                            get("h", 0), get("v", 0), get("zoom", 0),
                            int(get("ss", 1)))
                        self._send(200, "image/png", png)
                elif url.path == "/skybox":
                    png = state.skybox_png(name, int(get("size", 128)))
                    self._send(200, "image/png", png)
                elif url.path == "/newgalaxy":
                    self._json({"galaxy": state.new_galaxy(qs("name"))})
                elif url.path == "/clonegalaxy":
                    self._json({"galaxy": state.clone_galaxy(name,
                                                             qs("name"))})
                elif url.path == "/delgalaxy":
                    state.delete_galaxy(name)
                    self._json({"ok": True})
                elif url.path == "/reset":
                    if name:
                        state.edited.pop(state._resolve(name), None)
                    else:
                        state.edited.pop(next(iter(state.galaxies)), None)
                    self._json({"reset": True})
                else:
                    self._send(404, "text/plain", b"not found")
            except Exception as e:  # noqa: BLE001 - reported to the client
                code = 400 if isinstance(e, (ValueError, KeyError)) else 500
                self._send(code, "text/plain", str(e).encode())

    return Handler


def serve(port: int = 8000, size: int = 256, gax_dir: str | None = None,
          poll: bool = True, device="cuda"):
    """Serve the editor on 127.0.0.1:``port`` (0 picks a free port; the
    server's ``server_address`` names it) with ``size``-pixel previews,
    the galaxies of ``gax_dir`` (default ``models.presets.FIXTURE_DIR``)
    and the presets, rendering on ``device``. With ``poll`` this serves
    until interrupted; otherwise the server is returned unstarted. The
    server's ``state`` is the editor's session (``_ViewerState``)."""
    state = _ViewerState(size, Path(gax_dir) if gax_dir else FIXTURE_DIR,
                         device)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    httpd.state = state
    print(f"gamer-tpu editor on http://127.0.0.1:{httpd.server_address[1]}/ "
          f"({len(state.galaxies)} galaxies, {size}px preview, "
          f"{state.device})", flush=True)
    if poll:
        httpd.serve_forever()
    return httpd


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    serve(args.port, args.size, args.dir, device=args.device)
