"""Per-pass pipeline debug data (counterpart of the data half of
clap_tpu/render/passbrowser.py; reference: core/pipeline-debug.c:268 — a
window previewing every pass's FBO texture with entity/cull counts).

``render_frame_debug`` runs the canonical frame with tap collection on
(render_frame's ``_taps``), returning every pass's intermediate image —
shadow atlas, model-pass MRT (lighting HDR, emission, view normals,
depth), edge key and mask, SMAA weights, SSAO, bloom and the combine
output — plus per-env scene counts (valid faces, shadow casters, hit
pixels). The labelled thumbnail grid of the JAX package
(``compose_pass_browser``) needs the UI and font layers, which the port
does not have yet.
"""
from __future__ import annotations

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
