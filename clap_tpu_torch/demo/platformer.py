"""Platformer demo (counterpart of demo/platformer.py) — the ldjam57
"Towards the Light" analogue (demo/ldjam57/main.c), driven by the
authored data level demo/level57.json: switches, platform groups,
characters, cameras and lights all load from the scene.json gameplay
blocks, with no game wiring in code beyond the rig and the footsteps.

The scripted run walks the controlled character onto raised switch box
A, revealing platform group 0, crosses the now-solid platforms, latches
switch B for group 1, cycles control to character 1 at 2/3 of the run
(the camera retargets) and reports whether anyone reached the light.
Footstep events from the rigs' motion clip play through the sound engine,
mixed one 60 Hz slice per frame into a WAV.

Usage:
  python -m clap_tpu_torch.demo.platformer [--frames N] [--level PATH]
      [--device DEV]

Runs on the CUDA card unless ``--device`` names another device.
``build_world`` wires the level once for the demo and for every other
caller (chip_smoke.py's level phase); ``run`` plays the scripted walk.
Each frame reads the control slot, the footstep events and the switches
back to the host, as the JAX demo does.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

LEVEL = Path(__file__).resolve().parents[2] / "demo" / "level57.json"
CLIPS = ["idle", "motion", "jump", "fall"]
GOAL_X = 25.0


def build_world(device=None, doc: str | None = None) -> dict:
    """The level's game on ``device`` (the card unless named), as
    demo/platformer.py:46-66 wires it: the level (``doc``, its JSON text;
    LEVEL's where None) through the loader with the level's asset pack
    (16 entities, 4 bodies), the demo rig on every character, footstep
    SFX on the motion clip, the switch/platform rules of its gameplay
    blocks. A dict of scene, load_s (the load's host seconds), gw
    (GameWorld) and session0 (the unbatched GameSessionState)."""
    from ..anim.system import anim_instances_init, anim_sfx_from_names
    from ..device import resolve_device
    from ..engine.game import GameSessionState, GameWorld
    from ..engine.gamelogic import game_state_init
    from ..scene.assets57 import asset_loader
    from ..scene.loader import load_scene
    from ..scene.testbed import build_demo_rig

    dev = resolve_device(device)
    doc = LEVEL.read_text() if doc is None else doc
    t0 = time.perf_counter()
    scene = load_scene(doc, asset_loader=asset_loader, max_entities=16,
                       max_bodies=4, device=dev)
    load_s = time.perf_counter() - t0
    if scene.game is None:
        raise ValueError("level declares no gameplay blocks")
    n_chars = scene.cfg.char_params.body.shape[0]
    K = scene.game.switch_entity.shape[0]
    # character rigs + frame-SFX: the motion clip fires alternating
    # footsteps at its contact frames (motion_frame_sfx scene.c:1239-1303)
    sk, lib, acfg = build_demo_rig(device=dev)
    sfx = anim_sfx_from_names(CLIPS, motion_segments=4, device=dev)
    gw = GameWorld(scene=scene.cfg, game=scene.game, anim=acfg, anim_sk=sk,
                   anim_lib=lib, sfx=sfx)
    session0 = GameSessionState(
        engine=scene.state0, game=game_state_init(K, n_chars, device=dev),
        anim=anim_instances_init(n_chars, with_sfx=True, device=dev),
        joint_mats=torch.eye(4, device=dev).repeat(n_chars, 3, 1, 1),
        sfx_events=torch.zeros(n_chars, 2, dtype=torch.bool, device=dev))
    return dict(scene=scene, load_s=load_s, gw=gw, session0=session0)


def _walk_inputs(n_chars: int, device):
    """Per character c, the one-env Inputs that walk character c along
    +x."""
    from ..bridge import tree_map
    from ..engine.step import inputs_zero

    out = []
    for c in range(n_chars):
        ins = tree_map(lambda x: x[None].clone(),
                       inputs_zero(n_chars, device=device))
        ins.motion[0, c, 0] = 1.0
        out.append(ins)
    return out


def run(w: dict, frames: int, switch_frame: int):
    """The scripted walk of one env for ``frames`` frames, Tab on frame
    ``switch_frame``: each frame the controlled character walks +x
    (game_step with the GameWorld's camera occlusion, on, as in the JAX
    demo). Returns a dict: gs (the last GameSessionState, one env),
    events [(frame, message)], control [the controlled character before
    each frame], traj (frames, C, 3) the characters' body positions on the
    device, footsteps [(frame, foot, char)], audio (the mixed samples,
    float32)."""
    from ..engine.game import game_step
    from ..scene.testbed import replicate_state
    from ..utils.sound import SoundEngine, synth_tone

    gw = w["gw"]
    gs = replicate_state(w["session0"], 1)
    dev = gs.engine.pos.device
    body = w["scene"].cfg.char_params.body.long()
    n_chars = body.shape[0]
    K = gs.game.switch_on.shape[1]
    walk = _walk_inputs(n_chars, dev)
    tab = (torch.zeros(1, dtype=torch.bool, device=dev),
           torch.ones(1, dtype=torch.bool, device=dev))
    snd = SoundEngine()
    foot_ids = (snd.add_sound(synth_tone(95.0, 0.09) * 0.8),
                snd.add_sound(synth_tone(110.0, 0.09) * 0.8))
    audio, footsteps, events, control = [], [], [], []
    traj = torch.zeros(frames, n_chars, 3, device=dev)
    seen = set()
    for f in range(frames):
        ctrl = int(gs.game.control[0])
        control.append(ctrl)
        gs = game_step(gw, gs, walk[ctrl],
                       next_character=tab[f == switch_frame])
        traj[f] = gs.engine.phys.pos[0, body]
        ev = gs.sfx_events[0].cpu().numpy()
        for c in range(n_chars):
            for foot in range(2):
                if ev[c, foot]:
                    snd.play(foot_ids[foot])
                    footsteps.append((f, foot, c))
        audio.append(snd.mix(snd.rate // 60))
        if f == switch_frame:
            events.append((f, f"control -> char {int(gs.game.control[0])} "
                           f"(connected "
                           f"{gs.game.connected[0].tolist()})"))
        on = gs.game.switch_on[0].tolist()
        for k in range(K):
            if on[k] and k not in seen:
                seen.add(k)
                events.append((f, f"switch {k} ON -> platforms visible: "
                               f"{int(gs.engine.visible[0].sum())}"))
    return dict(gs=gs, events=events, control=control, traj=traj,
                footsteps=footsteps,
                audio=np.concatenate(audio) if audio
                else np.zeros(0, np.float32))


def main(argv=None):
    """The demo's command line (``argv``: sys.argv[1:] where None).
    Returns ``run``'s dict."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="clap_tpu_torch.demo.platformer")
    ap.add_argument("--frames", type=int, default=900)
    ap.add_argument("--level", default=str(LEVEL))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..utils.sound import save_wav

    w = build_world(args.device, Path(args.level).read_text())
    scene = w["scene"]
    r = run(w, args.frames, args.frames * 2 // 3)
    st, gs = r["gs"].engine, r["gs"]
    for f, msg in r["events"]:
        print(f"frame {f}: {msg}")
    body = scene.cfg.char_params.body.tolist()
    pos = st.phys.pos[0].cpu().numpy()
    names = scene.entity_names
    reached = [c for c in range(len(body)) if pos[body[c], 0] > GOAL_X - 2.0]
    print("frames:", args.frames)
    for c in range(len(body)):
        print(f"char {c}: {pos[body[c]].round(2)}")
    print("switches on:", gs.game.switch_on[0].tolist())
    group = scene.game.platform_group.tolist()
    vis = st.visible[0].tolist()
    print("platforms visible:",
          [names[i] for i in range(len(names)) if group[i] >= 0 and vis[i]])
    print("camera eye:", st.camera.pos[0].cpu().numpy().round(2),
          "(orbits char", int(gs.game.control[0]), ")")
    wav = r["audio"]
    if wav.size:
        path = os.path.join(tempfile.gettempdir(), "platformer_audio.wav")
        save_wav(path, wav)
        fs = r["footsteps"]
        print(f"footsteps: {len(fs)} (first 5: {fs[:5]}) -> {path}"
              f" rms={float(np.sqrt(np.mean(wav ** 2))):.4f}")
    print("reached the light:", reached if reached else "no one (yet)")
    return r


if __name__ == "__main__":
    main()
