"""Minimal dependency-free SVG charting.

The reference renders with plotly + matplotlib (app.py:3-4) — neither is a
dependency of this framework, so it carries a small SVG backend
sufficient for its four analysis views: overlaid line plots (linear/log x),
dashed vertical markers, and stem plots.

``render(interactive=True)`` adds the reference UI's plotly affordances
(app.py:186-251) with zero external dependencies: wheel zoom (x; shift =
y), drag pan, double-click reset, hover coordinate readout, and zoom-state
persistence in sessionStorage (the `uirevision` analog — the view survives
a report reload in the same browser session).  The driving script is
``INTERACTIVE_JS`` — include it once per page.
"""
from __future__ import annotations

import itertools
import json
import math
from typing import List, Optional, Tuple

import numpy as np

_W, _H = 900, 320
_ML, _MR, _MT, _MB = 60, 20, 30, 45
_BG = "#111111"
_FG = "#00ff00"
_GRID = "#333333"
_TEXT = "#9adf9a"


def _esc(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


class Figure:
    """One SVG chart; add traces then render()."""

    def __init__(
        self,
        title: str,
        xlabel: str = "",
        ylabel: str = "",
        logx: bool = False,
        width: int = _W,
        height: int = _H,
    ):
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.logx = logx
        self.w, self.h = width, height
        self.traces: List[dict] = []
        self.vlines: List[Tuple[float, str]] = []

    def line(self, x, y, color: str, label: str = "", width: float = 1.2,
             opacity: float = 1.0, dash: Optional[str] = None):
        self.traces.append(dict(kind="line", x=np.asarray(x, float),
                                y=np.asarray(y, float), color=color,
                                label=label, lw=width, op=opacity, dash=dash))
        return self

    def stem(self, x, y, color: str, label: str = ""):
        self.traces.append(dict(kind="stem", x=np.asarray(x, float),
                                y=np.asarray(y, float), color=color,
                                label=label, lw=1.0, op=1.0, dash=None))
        return self

    def vline(self, x: float, color: str = "#ff5500"):
        self.vlines.append((float(x), color))
        return self

    # -- scaling ---------------------------------------------------------
    def _ranges(self):
        xs, ys = [], []
        for t in self.traces:
            x, y = t["x"], t["y"]
            m = np.isfinite(x) & np.isfinite(y)
            if self.logx:
                m &= x > 0
            if m.any():
                xs.append((x[m].min(), x[m].max()))
                ys.append((y[m].min(), y[m].max()))
        if not xs:
            return (0.0, 1.0), (0.0, 1.0)
        x0 = min(a for a, _ in xs); x1 = max(b for _, b in xs)
        y0 = min(a for a, _ in ys); y1 = max(b for _, b in ys)
        if x1 <= x0:
            x1 = x0 + 1
        if y1 <= y0:
            y1 = y0 + 1
        pad = 0.05 * (y1 - y0)
        return (x0, x1), (y0 - pad, y1 + pad)

    def _px(self, xr):
        x0, x1 = xr
        iw = self.w - _ML - _MR
        if self.logx:
            l0, l1 = math.log10(x0), math.log10(x1)

            def f(v):
                v = np.maximum(v, x0)
                return _ML + (np.log10(v) - l0) / (l1 - l0) * iw
        else:
            def f(v):
                return _ML + (v - x0) / (x1 - x0) * iw
        return f

    def _py(self, yr):
        y0, y1 = yr
        ih = self.h - _MT - _MB

        def f(v):
            return _MT + (y1 - v) / (y1 - y0) * ih
        return f

    def _xticks(self, xr):
        x0, x1 = xr
        if self.logx:
            lo, hi = math.ceil(math.log10(x0)), math.floor(math.log10(x1))
            return [10.0 ** e for e in range(lo, hi + 1)]
        return list(np.linspace(x0, x1, 6))

    @staticmethod
    def _fmt(v: float) -> str:
        if v == 0:
            return "0"
        if abs(v) >= 1000:
            return f"{v/1000:.3g}k"
        return f"{v:.3g}"

    _ids = itertools.count()

    def render(self, interactive: bool = False) -> str:
        xr, yr = self._ranges()
        px, py = self._px(xr), self._py(yr)
        fid = f"ip{next(Figure._ids)}"
        attrs = ""
        if interactive:
            # Axis-space view description for INTERACTIVE_JS: L(v) = log10(v)
            # on a log x axis, identity otherwise.  All zoom/pan math runs
            # in pixel/axis space, so the traces group only needs a matrix
            # transform — paths are never re-generated.
            meta = dict(
                lx0=math.log10(xr[0]) if self.logx else xr[0],
                lx1=math.log10(xr[1]) if self.logx else xr[1],
                y0=yr[0], y1=yr[1], logx=bool(self.logx),
                ml=_ML, mt=_MT, iw=self.w - _ML - _MR,
                ih=self.h - _MT - _MB,
            )
            attrs = (f' class="iplot" id="{fid}" data-ip=\''
                     f'{json.dumps(meta)}\'')
        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{self.w}" '
            f'height="{self.h}"{attrs} '
            f'style="background:{_BG};font-family:monospace">'
        ]
        if interactive:
            parts.append(
                f'<defs><clipPath id="{fid}c"><rect x="{_ML}" y="{_MT}" '
                f'width="{self.w-_ML-_MR}" height="{self.h-_MT-_MB}"/>'
                f'</clipPath></defs>'
            )
            parts.append('<g class="ip-grid">')
        # grid + ticks
        for xt in self._xticks(xr):
            if xt < xr[0] or xt > xr[1]:
                continue
            X = px(xt)
            parts.append(f'<line x1="{X:.1f}" y1="{_MT}" x2="{X:.1f}" '
                         f'y2="{self.h-_MB}" stroke="{_GRID}" stroke-width="0.5"/>')
            parts.append(f'<text x="{X:.1f}" y="{self.h-_MB+16}" fill="{_TEXT}" '
                         f'font-size="10" text-anchor="middle">{self._fmt(xt)}</text>')
        for yt in np.linspace(yr[0], yr[1], 5):
            Y = py(yt)
            parts.append(f'<line x1="{_ML}" y1="{Y:.1f}" x2="{self.w-_MR}" '
                         f'y2="{Y:.1f}" stroke="{_GRID}" stroke-width="0.5"/>')
            parts.append(f'<text x="{_ML-6}" y="{Y+3:.1f}" fill="{_TEXT}" '
                         f'font-size="10" text-anchor="end">{self._fmt(yt)}</text>')
        if interactive:
            parts.append('</g>')
            parts.append(f'<g class="ip-view" clip-path="url(#{fid}c)">')
        vec = ' vector-effect="non-scaling-stroke"' if interactive else ""
        # vlines
        for xv, color in self.vlines:
            if xr[0] <= xv <= xr[1]:
                X = px(xv)
                parts.append(
                    f'<line x1="{X:.1f}" y1="{_MT}" x2="{X:.1f}" '
                    f'y2="{self.h-_MB}" stroke="{color}" stroke-width="1" '
                    f'stroke-dasharray="5,4" opacity="0.7"{vec}/>'
                )
        # traces
        y_base = py(max(yr[0], min(0.0, yr[1])))
        for t in self.traces:
            X, Y = px(t["x"]), py(t["y"])
            if t["kind"] == "stem":
                for xi, yi in zip(X, Y):
                    parts.append(
                        f'<line x1="{xi:.1f}" y1="{y_base:.1f}" x2="{xi:.1f}" '
                        f'y2="{yi:.1f}" stroke="{t["color"]}" stroke-width="1"{vec}/>'
                    )
                    parts.append(
                        f'<circle cx="{xi:.1f}" cy="{yi:.1f}" r="2.4" '
                        f'fill="{t["color"]}"/>'
                    )
            else:
                pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(X, Y))
                dash = f' stroke-dasharray="{t["dash"]}"' if t["dash"] else ""
                parts.append(
                    f'<polyline points="{pts}" fill="none" '
                    f'stroke="{t["color"]}" stroke-width="{t["lw"]}" '
                    f'opacity="{t["op"]}"{dash}{vec}/>'
                )
        if interactive:
            parts.append('</g>')
            # Hover crosshair + readout + event surface (JS drives these).
            parts.append(
                f'<g class="ip-hover" visibility="hidden">'
                f'<line class="ip-hx" x1="0" y1="{_MT}" x2="0" '
                f'y2="{self.h-_MB}" stroke="#777" stroke-width="0.7"/>'
                f'<line class="ip-hy" x1="{_ML}" y1="0" x2="{self.w-_MR}" '
                f'y2="0" stroke="#777" stroke-width="0.7"/>'
                f'<text class="ip-ht" x="{self.w-_MR-4}" y="{_MT+12}" '
                f'fill="#e8ffe8" font-size="10" text-anchor="end"></text></g>'
            )
            parts.append(
                f'<rect class="ip-evt" x="{_ML}" y="{_MT}" '
                f'width="{self.w-_ML-_MR}" height="{self.h-_MT-_MB}" '
                f'fill="transparent" style="cursor:crosshair"/>'
            )
        # title/labels/legend
        parts.append(f'<text x="{_ML}" y="18" fill="{_FG}" font-size="13">'
                     f'{_esc(self.title)}</text>')
        if self.xlabel:
            parts.append(f'<text x="{(self.w)//2}" y="{self.h-8}" fill="{_TEXT}" '
                         f'font-size="11" text-anchor="middle">{_esc(self.xlabel)}</text>')
        if self.ylabel:
            parts.append(
                f'<text x="14" y="{self.h//2}" fill="{_TEXT}" font-size="11" '
                f'text-anchor="middle" transform="rotate(-90 14 {self.h//2})">'
                f'{_esc(self.ylabel)}</text>')
        lx = self.w - _MR - 10
        for i, t in enumerate(self.traces):
            if t["label"]:
                parts.append(
                    f'<text x="{lx}" y="{_MT + 14 + 14*i}" fill="{t["color"]}" '
                    f'font-size="11" text-anchor="end">{_esc(t["label"])}</text>')
        parts.append("</svg>")
        return "".join(parts)


# Vanilla-JS driver for every .iplot SVG on the page: wheel = zoom x
# (shift = zoom y), drag = pan, double-click = reset, hover = coordinate
# readout.  Views persist in sessionStorage under "ipview_<KEY>_<index>"
# — substitute %(key)s with a per-report session id (the uirevision
# analog, app.py:186-199).  All math runs in axis space (log10 on log-x
# charts), so the trace group needs only a matrix transform and the grid
# is re-labelled from the visible range.
INTERACTIVE_JS = r"""
(function(){
 'use strict';
 var NS='http://www.w3.org/2000/svg';
 function fmt(v){
   if(v===0) return '0';
   if(Math.abs(v)>=1000) return (v/1000).toPrecision(3).replace(/\.?0+$/,'')+'k';
   return v.toPrecision(3).replace(/(\.\d*?)0+$/,'$1').replace(/\.$/,'');
 }
 document.querySelectorAll('svg.iplot').forEach(function(svg,idx){
  var m=JSON.parse(svg.getAttribute('data-ip'));
  var key='ipview_%(key)s_'+idx;
  var full={x0:m.lx0,x1:m.lx1,y0:m.y0,y1:m.y1};
  var v={x0:m.lx0,x1:m.lx1,y0:m.y0,y1:m.y1};
  try{var s=sessionStorage.getItem(key); if(s){var p=JSON.parse(s);
      if(isFinite(p.x0)&&p.x1>p.x0&&p.y1>p.y0) v=p;}}catch(e){}
  var view=svg.querySelector('.ip-view'), grid=svg.querySelector('.ip-grid');
  var evt=svg.querySelector('.ip-evt'), hov=svg.querySelector('.ip-hover');
  var hx=svg.querySelector('.ip-hx'), hy=svg.querySelector('.ip-hy');
  var ht=svg.querySelector('.ip-ht');
  // original px mapping (what the server rendered against)
  function pxo(u){return m.ml+(u-full.x0)/(full.x1-full.x0)*m.iw;}
  function pyo(w){return m.mt+(full.y1-w)/(full.y1-full.y0)*m.ih;}
  function apply(){
    var a=m.iw/(pxo(v.x1)-pxo(v.x0)), b=m.ml-a*pxo(v.x0);
    var d=m.ih/(pyo(v.y0)-pyo(v.y1)), f=m.mt-d*pyo(v.y1);
    view.setAttribute('transform','matrix('+a+' 0 0 '+d+' '+b+' '+f+')');
    redrawGrid();
    try{sessionStorage.setItem(key,JSON.stringify(v));}catch(e){}
  }
  function mk(tag,at){var e=document.createElementNS(NS,tag);
    for(var k in at) e.setAttribute(k,at[k]); return e;}
  function redrawGrid(){
    while(grid.firstChild) grid.removeChild(grid.firstChild);
    var xs=[];
    if(m.logx && (v.x1-v.x0)>=1){
      for(var e=Math.ceil(v.x0); e<=Math.floor(v.x1); e++) xs.push(e);
    } else { for(var i=0;i<6;i++) xs.push(v.x0+(v.x1-v.x0)*i/5); }
    xs.forEach(function(u){
      var X=m.ml+(u-v.x0)/(v.x1-v.x0)*m.iw;
      grid.appendChild(mk('line',{x1:X,y1:m.mt,x2:X,y2:m.mt+m.ih,
        stroke:'#333333','stroke-width':'0.5'}));
      var t=mk('text',{x:X,y:m.mt+m.ih+16,fill:'#9adf9a',
        'font-size':'10','text-anchor':'middle'});
      t.textContent=fmt(m.logx?Math.pow(10,u):u);
      grid.appendChild(t);
    });
    for(var i=0;i<5;i++){
      var w=v.y0+(v.y1-v.y0)*i/4;
      var Y=m.mt+(v.y1-w)/(v.y1-v.y0)*m.ih;
      grid.appendChild(mk('line',{x1:m.ml,y1:Y,x2:m.ml+m.iw,y2:Y,
        stroke:'#333333','stroke-width':'0.5'}));
      var t=mk('text',{x:m.ml-6,y:Y+3,fill:'#9adf9a','font-size':'10',
        'text-anchor':'end'});
      t.textContent=fmt(w); grid.appendChild(t);
    }
  }
  function dataAt(ev){
    var r=svg.getBoundingClientRect();
    var px=(ev.clientX-r.left)*svg.width.baseVal.value/r.width;
    var py=(ev.clientY-r.top)*svg.height.baseVal.value/r.height;
    return {px:px,py:py,
      u:v.x0+(px-m.ml)/m.iw*(v.x1-v.x0),
      w:v.y1-(py-m.mt)/m.ih*(v.y1-v.y0)};
  }
  evt.addEventListener('wheel',function(ev){
    ev.preventDefault();
    var c=dataAt(ev), k=Math.pow(1.18,ev.deltaY>0?1:-1);
    if(ev.shiftKey){
      v.y0=c.w-(c.w-v.y0)*k; v.y1=c.w+(v.y1-c.w)*k;
    }else{
      v.x0=c.u-(c.u-v.x0)*k; v.x1=c.u+(v.x1-c.u)*k;
    }
    apply();
  },{passive:false});
  var drag=null;
  evt.addEventListener('mousedown',function(ev){drag=dataAt(ev);});
  window.addEventListener('mouseup',function(){drag=null;});
  evt.addEventListener('mousemove',function(ev){
    var c=dataAt(ev);
    if(drag){
      var du=drag.u-c.u, dw=drag.w-c.w;
      v.x0+=du; v.x1+=du; v.y0+=dw; v.y1+=dw;
      apply(); return;
    }
    hov.setAttribute('visibility','visible');
    hx.setAttribute('x1',c.px); hx.setAttribute('x2',c.px);
    hy.setAttribute('y1',c.py); hy.setAttribute('y2',c.py);
    ht.textContent='x='+fmt(m.logx?Math.pow(10,c.u):c.u)+'  y='+fmt(c.w);
  });
  evt.addEventListener('mouseleave',function(){
    hov.setAttribute('visibility','hidden');});
  evt.addEventListener('dblclick',function(){
    v={x0:full.x0,x1:full.x1,y0:full.y0,y1:full.y1}; apply();});
  if(v.x0!==full.x0||v.x1!==full.x1||v.y0!==full.y0||v.y1!==full.y1) apply();
 });
})();
"""


def interactive_script(session_key: str) -> str:
    """The <script> block enabling zoom/pan/hover on every .iplot figure."""
    return "<script>%s</script>" % (INTERACTIVE_JS.replace("%(key)s",
                                                           session_key))


def decimate_for_display(data: np.ndarray, max_points: int = 2500) -> np.ndarray:
    """Stride decimation for plotting (reference: app.py:102-106)."""
    data = np.asarray(data)
    if len(data) > max_points:
        step = int(np.ceil(len(data) / max_points))
        return data[::step]
    return data
