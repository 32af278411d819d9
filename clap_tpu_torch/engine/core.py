"""Engine orchestrator (counterpart of clap_tpu/engine/core.py; reference:
core/clap.{c,h} — context, init ordering, frame loop, timers, CLI,
restart).

``Engine`` owns the host rim: scene/content, settings, telemetry, the
profiler, frame timers, and the step and render. The per-frame order
mirrors clap_frame (clap.c:551-665):

  timers → input dispatch → [characters_move → phys_step → scene sync →
  camera] → gameplay rules → [render] → UI composite →
  profiler/telemetry.

clap_init's ordered bring-up (clap.c:1053-1173) maps to Engine.__init__;
clap_restart (clap.c:833-848: teardown + execve self) is replicated for
the dev loop.

The JAX package's Engine is single-env and jits its step and render; the
port holds a 1-env batch (leading axis 1) on ``device`` (the card unless
named) and calls ``game_step`` / ``engine_step`` and the
``GameFrameRenderer`` eagerly. ``Engine.frame`` takes the JAX package's
unbatched Inputs ((n_chars, 2) motion) and adds the env axis itself;
``last_frame`` is the env's (H, W, 3) image. A frame reads nothing back
to the host unless something attached asks for it: the display's camera
yaw while a client is connected, the footstep events while sound is
attached, the frame for the PNG dump and the display, and the NaN
watchdog every 60 frames. The profiler's segments time the host's
dispatch, not the card.
"""
from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..bridge import tree_map
from ..device import resolve_device
from ..ops.particles import PARTICLES_MAX
from ..utils.bus import MT, Message, MessageBus
from ..utils.logger import ERR, Logger, RingSink
from ..utils.profiler import Profiler
from ..utils.settings import Settings
from ..utils.telemetry import TelemetryClient
from .fuzzer import fuzz_inputs
from .step import Inputs, engine_step, inputs_zero


@dataclass
class ClapConfig:
    """struct clap_config (clap.h:413-439): subsystem enables +
    callbacks."""

    title: str = "clap-tpu"
    graphics: bool = False
    input: bool = True
    sound: bool = False
    phys: bool = True
    fuzzer: bool = False
    settings: bool = True
    networking: bool = False
    server_ip: str = "127.0.0.1"
    width: int = 1280
    height: int = 720
    frame_cb: Callable | None = None
    early_init: Callable | None = None
    graphics_init: Callable | None = None
    exit_after: int = 0          # seconds; 0 = run forever (-e CLI)
    abort_on_error: bool = False


def parse_cli(argv, cfg: ClapConfig) -> ClapConfig:
    """Declarative option handling (clap.c:868-925: --help/--fullscreen/
    --exitafter/--aoe/--server)."""
    import argparse

    p = argparse.ArgumentParser(prog=cfg.title)
    p.add_argument("-e", "--exitafter", type=int, default=cfg.exit_after,
                   help="exit after N seconds (automated runs)")
    p.add_argument("-E", "--aoe", action="store_true",
                   help="abort on error")
    p.add_argument("-F", "--fullscreen", action="store_true")
    p.add_argument("-S", "--server", default=cfg.server_ip,
                   help="telemetry server ip")
    p.add_argument("--fuzzer", action="store_true")
    args, _ = p.parse_known_args(argv)
    cfg.exit_after = args.exitafter
    cfg.abort_on_error = cfg.abort_on_error or args.aoe
    cfg.server_ip = args.server
    cfg.fuzzer = cfg.fuzzer or args.fuzzer
    return cfg


def graphics_renderer(entity_mx0, render_tables, lights, opts,
                      skip_culling=None, fov: float = math.pi / 3,
                      textures=None, lut_volume=None, grain_noise=None,
                      particle_world=None, particle_size: float = 0.12,
                      particle_color=(0.9, 0.9, 0.6), char_skin=None,
                      n_particles: int = PARTICLES_MAX):
    """The GameFrameRenderer that ``Engine.attach_graphics`` draws with,
    from attach_graphics's own arguments: the static casters' atlas baked
    from the entity matrices ``entity_mx0`` (E, 4, 4), the particle
    systems of ``particle_world`` (the GameWorld's ParticleParams, None
    for none) with ``n_particles`` per system."""
    from .frame import GameFrameRenderer

    return GameFrameRenderer(
        render_tables, lights, opts, skip_culling=skip_culling, fov=fov,
        textures=textures, lut_volume=lut_volume, grain_noise=grain_noise,
        particle_params=particle_world, n_particles=n_particles,
        particle_size=particle_size, particle_color=particle_color,
        char_skin=char_skin, entity_mx0=entity_mx0)


def _copy(tree, device=None):
    """A copy of a tree's tensors that no later frame writes into, on
    ``device`` where one is named."""
    return tree_map(lambda x: x.to(device or x.device, copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


def _to(tree, device):
    """A tree's tensors on ``device`` (those already there as they are)."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, tree)


class Engine:
    """The clap context analogue."""

    def __init__(self, cfg: ClapConfig, scene_cfg, state0, argv=(),
                 game_world=None, session0=None, device=None,
                 seed: int = 0):
        """game_world/session0: optionally step the FULL composed game
        (rules + batched rig animation + particles, engine/game.py)
        instead of the bare engine_step — the clap_frame composition.
        ``state0`` / ``session0`` are unbatched, as the JAX package's;
        the Engine holds them as a 1-env batch. It holds them, the scene
        and the game world on ``device`` (the card unless named), moved
        there where the caller built them elsewhere. ``seed`` seeds the
        fuzzer's stream and the particles' generator (on ``device``)."""
        from ..scene.testbed import replicate_state

        self.cfg = parse_cli(list(argv), cfg)
        self.device = resolve_device(device)
        self.bus = MessageBus()
        self.bus.subscribe(MT.COMMAND, self._handle_command)
        # leveled logger + ring sink (log_init clap.c:1111; the ring
        # drains to the telemetry server like networking.c:98)
        self.log = Logger(abort_on_error=self.cfg.abort_on_error)
        self.log_ring = RingSink(capacity=256)
        self.log.add_sink(self.log_ring)
        self.profiler = Profiler()
        self.telemetry = None
        if cfg.networking:
            self.telemetry = TelemetryClient(
                cfg.server_ip, on_command=self._net_command)
        if cfg.early_init:
            cfg.early_init(self)
        self.settings = Settings(on_load=None) if cfg.settings else None
        self.scene_cfg = _to(scene_cfg, self.device)
        self.timers: list[tuple[float, Callable]] = []
        self._restart = False
        self._stop = False
        self.frame_no = 0
        self.seed = seed
        self.fuzz_seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.n_chars = scene_cfg.char_params.body.shape[0]
        self.session = None
        self._game_world = _to(game_world, self.device)
        # the initial state, a copy of the caller's on the Engine's device
        # that nothing writes into (a 1-env replica is a view of it); the
        # watchdog's reset copies it again
        if game_world is not None:
            self._session0 = _copy(replicate_state(session0, 1),
                                   self.device)
            self.session = _copy(self._session0)
            self.state = self.session.engine
        else:
            self._state0 = _copy(replicate_state(state0, 1), self.device)
            self.state = _copy(self._state0)
        self._camera_occlusion = None     # the step's own default
        self._zero_inputs = inputs_zero(self.n_chars, device=self.device)
        self.renderer = None
        self._lut_volume = None
        self._render_particles = False
        self.last_frame = None
        self._frame_dir = None
        self.sound = None
        self.display = None
        self.editor = None
        if cfg.graphics_init:
            cfg.graphics_init(self)

    def attach_graphics(self, render_tables, lights, opts=None,
                        skip_culling=None, out_dir=None,
                        fov: float = math.pi / 3, textures=None,
                        lut_volume=None, grain_noise=None,
                        particle_world=None, particle_size: float = 0.12,
                        particle_color=(0.9, 0.9, 0.6), char_skin=None):
        """Wire per-frame rendering into Engine.frame (graphics=True:
        clap_frame IS update+render, clap.c:551-665). The camera comes
        from the step's own CameraState; frames land in self.last_frame
        and, when out_dir is set, as numbered PNGs.

        The full content path is plumbed, not just geometry: per-model
        ``textures`` (TextureSets), 3D-LUT grading volume, film-grain
        blue noise, and — when the session carries a ParticleState and
        ``particle_world`` (the GameWorld's ParticleParams) is given —
        the live particle systems render each frame (particle.c:122-125).

        When ``render_tables`` carries a static shadow stream
        (build_render_tables entity_shadow_static=), the static
        casters' atlas is baked ONCE here (the engine state's current
        pose, at max(shadow_size, 1024)²) and every frame's CSM only
        rasters the dynamic casters.

        char_skin (render.charskin.CharSkin): skinned characters — the
        session's joint_mats deform the char meshes every frame
        (model.vert:34-48; requires a game session that animates)."""
        from ..render.pipeline import RenderOptions

        if opts is None:
            opts = RenderOptions(width=self.cfg.width,
                                 height=self.cfg.height,
                                 film_grain=0.0 if grain_noise is None
                                 else 0.03)
        has_particles = (particle_world is not None
                         and self.session is not None
                         and self.session.particles is not None)
        self.renderer = graphics_renderer(
            self.state.mx[0], render_tables, lights, opts,
            skip_culling=skip_culling, fov=fov, textures=textures,
            grain_noise=grain_noise,
            particle_world=particle_world if has_particles else None,
            particle_size=particle_size, particle_color=particle_color,
            char_skin=char_skin,
            n_particles=(self.session.particles.pos.shape[2]
                         if has_particles else PARTICLES_MAX))
        # the LUT volume is a forward ARGUMENT, not a renderer buffer, so
        # lut_autoswitch_set cycles presets with nothing rebuilt
        self._lut_volume = lut_volume
        self._render_particles = has_particles
        self._frame_dir = out_dir
        self.cfg.graphics = True       # config now reflects behavior
        # with a visible frame the camera must not clip through terrain:
        # the step runs the occlusion shrink from now on (camera_update
        # camera.c:93-117 runs every reference frame; headless sims skip
        # the raycasts, which is why it's not on in __init__)
        self._camera_occlusion = True
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        return self.renderer

    def attach_sound(self, engine=None, footstep_left=None,
                     footstep_right=None, frame_rate: float = 60.0):
        """Wire the SoundEngine into the frame loop (the sfx_container
        hookup scene.c:1432-1433 + sfx_play in the frame callbacks):
        each frame, the session's sfx_events (footsteps fired by the
        animation system's frame hooks) trigger voices, and one frame's
        worth of audio is mixed into self.audio_buffer.

        footstep_left/right: sound ids in ``engine`` (defaults: two
        synthesized thumps). Requires a game session whose GameWorld
        wires AnimSfx."""
        from ..utils.sound import SoundEngine, synth_tone

        if engine is None:
            engine = SoundEngine()
        if footstep_left is None:
            footstep_left = engine.add_sound(
                synth_tone(95.0, 0.09) * 0.8)
        if footstep_right is None:
            footstep_right = engine.add_sound(
                synth_tone(110.0, 0.09) * 0.8)
        self.sound = engine
        self._footstep_ids = (footstep_left, footstep_right)
        self._audio_frame = int(round(engine.rate / frame_rate))
        self.audio_buffer = []
        self.voice_log = []    # (frame, foot, char) — test/debug hook
        self.cfg.sound = True
        return engine

    def _sound_frame(self):
        ev = getattr(self.session, "sfx_events", None)
        if ev is not None:
            ev = ev[0].cpu().numpy()          # the env's (C, 2) footsteps
            for c in range(ev.shape[0]):
                for foot in range(2):
                    if ev[c, foot]:
                        self.sound.play(self._footstep_ids[foot])
                        self.voice_log.append((self.frame_no, foot, c))
        self.audio_buffer.append(self.sound.mix(self._audio_frame))

    def attach_display(self, host: str = "127.0.0.1", port: int = 8080,
                       max_fps: float = 30.0):
        """Live browser display (display-www.c + input-www.c analogue):
        serves http://host:port/ and streams rendered frames over a
        WebSocket; browser key events feed the frame loop's inputs
        (when the caller passes none). Requires attach_graphics."""
        from ..render.display import DisplayServer

        self.display = DisplayServer(host, port, max_fps=max_fps)
        return self.display

    def lut_autoswitch_set(self, period_s: float, volumes=None):
        """Cycle the grading LUT every ``period_s`` seconds through the
        preset list (scene_lut_autoswitch, scene.c:93-129 + lut_next):
        a re-arming frame timer swaps self._lut_volume, which the render
        takes as an argument (nothing is rebuilt).

        period_s <= 0 cancels (the reference's timer simply doesn't
        re-arm when lut_autoswitch is cleared). Pass ``volumes`` to
        cycle a custom list; default bakes all 14 LUT_PRESETS on the
        Engine's device."""
        if period_s <= 0:
            self._lut_cycle = None
            return
        if volumes is None:
            from ..render.lut import LUT_PRESETS, bake_lut

            volumes = [bake_lut(p, device=self.device) for p in LUT_PRESETS]
        self._lut_cycle = list(volumes)
        self._lut_idx = 0
        if self._lut_volume is None and self._lut_cycle:
            self._lut_volume = self._lut_cycle[0]

        def tick(eng):
            cycle = getattr(eng, "_lut_cycle", None)
            if not cycle:
                return                      # cancelled: don't re-arm
            eng._lut_idx = (eng._lut_idx + 1) % len(cycle)
            eng._lut_volume = cycle[eng._lut_idx]
            eng.timer_set(period_s, tick)

        self.timer_set(period_s, tick)

    # --- timers (clap.c:339-439: sorted one-shot list) ---
    def timer_set(self, delay_s: float, fn: Callable):
        self.timers.append((time.monotonic() + delay_s, fn))
        self.timers.sort(key=lambda t: t[0])

    def _timers_run(self):
        now = time.monotonic()
        while self.timers and self.timers[0][0] <= now:
            _, fn = self.timers.pop(0)
            fn(self)

    def _handle_command(self, msg: Message) -> int:
        if msg.data.get("cmd") == "restart":
            self._restart = True
        elif msg.data.get("cmd") == "exit":
            self._stop = True
        return 0

    def _net_command(self, msg):
        self.bus.send(Message(MT.COMMAND, data={"cmd": msg.get("command")}))

    # --- frame (clap_frame, clap.c:551-665, headless core) ---
    def attach_editor(self, loaded_scene):
        """In-engine scene editor (scene.c:174-304): F1 toggles it,
        edits apply to the LIVE state (and session), `editor.save(
        engine.state)` re-serializes scene.json."""
        from ..scene.editor import SceneEditor

        self.editor = SceneEditor(loaded_scene)
        return self.editor

    def route_editor(self, rec) -> bool:
        """Feed one input record to the editor; True when consumed
        (the edited state replaces the live engine/session state)."""
        st, consumed = self.editor.handle_input(rec, self.state)
        if consumed:
            self.state = st
            if self.session is not None:
                self.session = self.session._replace(engine=st)
        return consumed

    def _frame_inputs(self):
        """The frame's own inputs where the caller gives none: the
        fuzzer's stream, else the display's record, else none."""
        if self.cfg.fuzzer:
            # one stream for the env; every character takes it, as the
            # JAX package's single-character draw reaches them all
            ins = fuzz_inputs(self.fuzz_seed, self.frame_no,
                              device=self.device)
            C = max(self.n_chars, 1)
            return ins._replace(motion=ins.motion.expand(C, 2),
                                jump=ins.jump.expand(C))
        if self.display is not None and self.display.n_clients:
            from .input import record_to_inputs

            rec = self.display.record
            if self.editor is not None and self.route_editor(rec):
                return self._zero_inputs         # editor consumed it
            return record_to_inputs(
                rec, float(self.state.camera.yaw[0]),
                n_chars=max(self.n_chars, 1), device=self.device)
        return self._zero_inputs

    def frame(self, inputs: Inputs | None = None, dt: float = 1 / 60):
        self.profiler.frame_begin()
        self._timers_run()
        self.profiler.step("timers")

        if inputs is None:
            inputs = self._frame_inputs()
        inputs = tree_map(lambda x: x[None], inputs)      # the env axis
        self.profiler.step("input")

        if self.session is not None:
            from .game import game_step

            self.session = game_step(
                self._game_world, self.session, inputs, dt,
                camera_occlusion=self._camera_occlusion,
                generator=self.generator)
            self.state = self.session.engine
        else:
            self.state = engine_step(
                self.scene_cfg, self.state, inputs, dt,
                camera_occlusion=bool(self._camera_occlusion))
        self.profiler.step("sim")

        if self.sound is not None and self.session is not None:
            self._sound_frame()
        self.profiler.step("sound")

        if self.renderer is not None and self.cfg.graphics:
            parts = self.session.particles if self._render_particles \
                else None
            jm = self.session.joint_mats if self.session is not None \
                else None
            self.last_frame = self.renderer(self.state, parts,
                                            self._lut_volume, jm)[0]
            if self._frame_dir:
                from ..utils.png import save_png

                save_png(os.path.join(self._frame_dir,
                                      f"frame_{self.frame_no:04d}.png"),
                         self.last_frame.cpu().numpy())
            if self.display is not None:
                self.display.push_frame(self.last_frame)
        self.profiler.step("render")

        if self.cfg.frame_cb:
            self.cfg.frame_cb(self)
        self.profiler.step("callback")

        self.frame_no += 1
        self.profiler.frame_end()
        if self.frame_no % 60 == 0:  # 1 Hz status + NaN watchdog
            self._watchdog()

    def _watchdog(self):
        """The 1 Hz status tick. Sanitizer analogue (SURVEY §5.2): a NaN
        in the state would silently poison every later frame — abort
        under -E (clap.c:909-915) or degrade-and-continue by resetting to
        a copy of the initial state (the cerr containment path,
        clap.c:627-648)."""
        from ..utils.guards import assert_finite

        try:
            assert_finite(self.state)
        except FloatingPointError as e:
            if self.cfg.abort_on_error:
                raise
            self.bus.send(Message(MT.LOG, data={
                "level": "err", "msg": f"state corrupt ({e}); resetting"}))
            self.log.err(f"state corrupt ({e}); resetting", mod="engine")
            if self.session is not None:
                self.session = _copy(self._session0)
                self.state = self.session.engine
            else:
                self.state = _copy(self._state0)
            self.generator.manual_seed(self.seed)
        if self.telemetry:
            self.telemetry.status(fps=self.profiler.fps,
                                  frame=self.frame_no)
            for entry in self.log_ring.drain():   # networking.c:98
                self.telemetry.log(
                    "err" if entry.level >= ERR else "msg", entry.msg)
            self.telemetry.poll()

    def run(self, max_frames: int | None = None):
        """display_main_loop analogue (display-glfw.c:356-361)."""
        deadline = (time.monotonic() + self.cfg.exit_after
                    if self.cfg.exit_after else None)
        while not self._stop and not self._restart:
            self.frame()
            if max_frames is not None and self.frame_no >= max_frames:
                break
            if deadline and time.monotonic() >= deadline:
                break
        if self._restart:
            self.restart()

    def restart(self):
        """clap_restart (clap.c:833-848): re-exec self with the command
        line it was started with (``python -m`` included)."""
        os.execv(sys.executable, [sys.executable] + sys.orig_argv[1:])
