"""The composed frame sharded over the env axis (counterpart of
``dryrun_multichip`` in __graft_entry__.py:74-193).

``dryrun_multichip(n)`` runs one composed frame on an ``n``-entry mesh:
``game_step`` (sim, rules, batched rig animation), the skinned cluster
records and ``render_frame_dynamic_batch``, with the per-env state sharded
over the mesh, the render tables replicated, and the mean luma over every
env as the one cross-env reduction. ``multichip_world`` builds the same
world unsharded, so a caller can run it both ways.
"""
from __future__ import annotations

import math

import torch

from ..bridge import tree_map
from ..engine.frame import SceneRenderer, step_and_render
from .sharding import (env_mean, env_mesh, gather_envs, map_shards,
                       replicate, shard_envs)

# __graft_entry__.py:17-21, the entry() scene
SMALL_TESTBED = dict(seed=7, side=32.0, nr_v=32, n_dynamic=4,
                     max_entities=32)


def multichip_world(n_envs: int, device=None) -> dict:
    """The dryrun's world on ``device`` (the card unless named), as
    __graft_entry__.py:120-170 builds it: the small testbed, the one-switch
    game config and the demo rig, skinned characters over the testbed's
    models, one directional light, a 32 × 32 frame with 32² cascades, no
    film grain or SSAO, kernel attrs where the tables allow, and
    ``n_envs`` envs at the first state walking +x. Returns a dict: gw,
    renderer (SceneRenderer; 4,096 cluster records, far 100), gs, ins."""
    from ..anim.system import anim_instances_init
    from ..device import resolve_device
    from ..engine.game import GameSessionState, GameWorld
    from ..engine.gamelogic import game_config_empty, game_state_init
    from ..engine.step import inputs_zero
    from ..render.lights import lights_empty
    from ..render.pipeline import RenderOptions
    from ..render.scenerender import (build_render_tables, default_edge_ids,
                                      kernel_attrs_ok)
    from ..scene import testbed as tbm

    dev = resolve_device(device)
    tb = tbm.build_testbed(**SMALL_TESTBED, device=dev)
    sk, lib, acfg = tbm.build_demo_rig(device=dev)
    gcfg = game_config_empty(1, 32, device=dev)._replace(
        switch_entity=torch.tensor([0], dtype=torch.int32, device=dev),
        switch_valid=torch.tensor([True], device=dev),
        switch_permanent=torch.tensor([True], device=dev))
    gw = GameWorld(scene=tb.cfg, game=gcfg, anim=acfg, anim_sk=sk,
                   anim_lib=lib)
    gs1 = GameSessionState(
        engine=tb.state0, game=game_state_init(1, 1, device=dev),
        anim=anim_instances_init(1, device=dev),
        joint_mats=torch.eye(4, device=dev).repeat(1, 3, 1, 1))
    models = tbm.testbed_models(tb, with_lods=False, skinned_chars=True)
    ent = tb.cfg.entities
    rt = build_render_tables(
        models, ent.model_id, ent.active,
        entity_edge_id=default_edge_ids(ent.active, ent.body_is_char),
        device=dev)
    cs = tbm.build_testbed_char_skin(tb, models, rt, device=dev)
    lights = lights_empty(1, device=dev)
    d = torch.tensor([-0.4, -0.8, -0.4], device=dev)
    lights = lights._replace(
        direction=(d / torch.linalg.vector_norm(d))[None],
        color=torch.ones_like(lights.color),
        is_dir=torch.ones_like(lights.is_dir),
        active=torch.ones_like(lights.active))
    # record_compact: the cluster records' capacity (the dryrun's cap=4096)
    opts = RenderOptions(width=32, height=32, shadow_size=32,
                         film_grain=0.0, ssao=False, record_compact=4096,
                         kernel_attrs=kernel_attrs_ok(rt))
    renderer = SceneRenderer(rt, lights, opts, skip_culling=ent.skip_culling,
                             fovy=math.pi / 3, far=100.0, char_skin=cs)
    gs = tbm.replicate_state(gs1, n_envs)
    ins = tree_map(lambda x: x.expand(n_envs, *x.shape).clone(),
                   inputs_zero(1, device=dev))
    ins.motion[:, 0, 0] = 1.0
    return dict(gw=gw, renderer=renderer, gs=gs, ins=ins)


def dryrun_multichip(n_devices: int, devices=None):
    """One composed frame with the env axis sharded over an
    ``n_devices``-entry mesh (``env_mesh(n_devices, devices=devices)``:
    every card by default), 2 envs per entry: the state and inputs sharded,
    the game world and renderer replicated, ``step_and_render`` on each
    shard, then the mean luma over every env's frame from the shards' sums.
    Checks that every env reached frame 1 and that the mean is finite.
    Returns (state, mean luma, frames), state and frames gathered on the
    mesh's first device."""
    mesh = env_mesh(n_devices, devices=devices)
    w = multichip_world(2 * mesh.size, mesh.devices[0])
    out = map_shards(step_and_render, mesh, replicate(w["gw"], mesh),
                     replicate(w["renderer"], mesh),
                     shard_envs(w["gs"], mesh), shard_envs(w["ins"], mesh))
    frames = [img for _, img in out]
    mean_luma = env_mean(frames)
    gs = gather_envs([g for g, _ in out])
    if not bool((gs.engine.frame == 1).all()):
        raise RuntimeError("dryrun_multichip: an env did not reach frame 1")
    if not bool(torch.isfinite(mean_luma)):
        raise RuntimeError("dryrun_multichip: the mean luma is not finite")
    return gs, mean_luma, gather_envs(frames)

