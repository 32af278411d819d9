"""Per-pass pipeline debug browser (counterpart of
clap_tpu/render/passbrowser.py; reference: core/pipeline-debug.c:268 — a
window previewing every pass's FBO texture with entity/cull counts).

``render_frame_debug`` runs the canonical frame with tap collection on
(render_frame's ``_taps``), returning every pass's intermediate image —
shadow atlas, model-pass MRT (lighting HDR, emission, view normals,
depth), edge key and mask, SMAA weights, SSAO, bloom and the combine
output — plus per-env scene counts (valid faces, shadow casters, hit
pixels). ``compose_pass_browser`` lays one env's taps out as normalized
thumbnails in a labelled grid on the host (numpy, as in the JAX
package), the labels blended by ``ui.ui_compose``: the pass-preview
window's image.
"""
from __future__ import annotations

import numpy as np
import torch

from .pipeline import PER_ENV, render_frame

# pass-chain display order (pipeline-builder.c:182-613)
PASS_ORDER = ["shadow_atlas", "lighting_hdr", "emission", "view_normals",
              "depth", "edge_key", "edges", "smaa_weights", "ssao",
              "bloom", "combine"]


def _count(geom, name: str, n_envs: int):
    """(B,) number of set entries of mask ``name`` per env; a mask shared
    by every env counts once for each."""
    m = getattr(geom, name)
    per_env = name in PER_ENV or name == "comp_valid"
    if per_env and m.dim() >= 2 and m.shape[0] == n_envs:
        return m.reshape(n_envs, -1).sum(1)
    return m.sum().expand(n_envs)


def render_frame_debug(opts, geom, cam_view, cam_proj, lights, eye, **kw):
    """Run the frame with per-pass taps. Returns (img, taps, counts):
    ``taps`` by pass name (``PASS_ORDER``), each (B, ...), and ``counts``
    of faces_valid, shadow_casters and hit_pixels, each (B,).

    Not meant for the hot loop (the taps keep every intermediate alive);
    this is the pass browser's data source."""
    taps = {}
    img = render_frame(opts, geom, cam_view, cam_proj, lights, eye,
                       _taps=taps, **kw)
    B = img.shape[0]
    counts = {}
    if getattr(geom, "comp_valid", None) is not None:
        counts["faces_valid"] = _count(geom, "comp_valid", B)
    elif geom.face_valid is not None:
        counts["faces_valid"] = _count(geom, "face_valid", B)
    if geom.shadow_face_valid is not None:
        counts["shadow_casters"] = _count(geom, "shadow_face_valid", B)
    if "depth" in taps:
        counts["hit_pixels"] = torch.isfinite(taps["depth"]).reshape(
            B, -1).sum(1)
    return img, taps, counts


def _host(a) -> np.ndarray:
    """A tap (a tensor on any device, or an array) as host float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _normalize(name: str, a) -> np.ndarray:
    """Map one tap to a displayable (h, w, 3) float image in [0, 1]."""
    a = _host(a)
    if name == "depth":
        # finite range → near white, far black (pipeline-debug's
        # linearized depth preview)
        fin = np.isfinite(a)
        if fin.any():
            lo, hi = a[fin].min(), a[fin].max()
            a = np.where(fin, 1.0 - (a - lo) / max(hi - lo, 1e-6), 0.0)
        else:
            a = np.zeros_like(a)
    elif name in ("shadow_atlas", "edge_key"):
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / max(hi - lo, 1e-6)
    elif name == "lighting_hdr":
        a = a / (1.0 + a)                      # quick tonemap preview
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    elif a.shape[-1] == 2:                     # e.g. SMAA weights
        a = np.concatenate([a, np.zeros_like(a[..., :1])], -1)
    elif a.shape[-1] > 3:
        a = a[..., :3]
    return np.clip(a, 0.0, 1.0)


def _thumb(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Nearest-neighbour resize (host-side debug path)."""
    h, w = img.shape[:2]
    yi = np.clip((np.arange(th) * h / th).astype(int), 0, h - 1)
    xi = np.clip((np.arange(tw) * w / tw).astype(int), 0, w - 1)
    return img[yi][:, xi]


def compose_pass_browser(taps: dict, counts: dict | None = None,
                         thumb_h: int = 90, thumb_w: int = 120,
                         cols: int = 4, font=None) -> np.ndarray:
    """Grid of labelled pass thumbnails — the pass-preview window's image.
    Returns (H, W, 3) float32 in [0, 1] on the host.

    ``taps`` and ``counts`` are ONE env's: ``render_frame_debug`` gives
    them with a leading env axis, so the caller indexes it, e.g.
    ``{k: v[e] for k, v in taps.items()}`` and the same for counts. Taps
    may be tensors on any device (each is read back once) or arrays."""
    from .ui import AF, UiElement, ui_compose, ui_layout

    names = [n for n in PASS_ORDER if n in taps] \
        + [n for n in taps if n not in PASS_ORDER]
    if not names:
        return np.zeros((thumb_h, thumb_w, 3), np.float32)
    pad, label_h = 4, 14
    rows = (len(names) + cols - 1) // cols
    cell_h = thumb_h + label_h + pad
    cell_w = thumb_w + pad
    H = rows * cell_h + pad
    W = cols * cell_w + pad
    canvas = np.full((H, W, 3), 0.08, np.float32)
    labels = []
    for i, n in enumerate(names):
        r, c = divmod(i, cols)
        y = pad + r * cell_h + label_h
        x = pad + c * cell_w
        canvas[y:y + thumb_h, x:x + thumb_w] = _thumb(
            _normalize(n, taps[n]), thumb_h, thumb_w)
        labels.append(UiElement(
            text=n, text_scale=1, affinity=AF.LEFT | AF.TOP,
            x=float(x), y=float(y - label_h), font=font,
            color=(0.0, 0.0, 0.0, 0.0)))
    if counts:
        txt = "  ".join(f"{k}={int(v)}" for k, v in counts.items())
        labels.append(UiElement(
            text=txt, text_scale=1, affinity=AF.LEFT | AF.TOP,
            x=float(pad), y=float(H - label_h), font=font,
            color=(0.0, 0.0, 0.0, 0.0)))
        # reserve a status line
        canvas = np.concatenate(
            [canvas, np.full((label_h + pad, W, 3), 0.08, np.float32)], 0)
        H = canvas.shape[0]
    out = ui_compose(torch.from_numpy(canvas), ui_layout(labels, W, H))
    return out.numpy()
