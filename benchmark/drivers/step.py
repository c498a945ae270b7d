"""The env-step traffic: the env stepped alone in a closed loop, each step's
actions drawn uniformly from ``--seed`` on the device, and the spawn slots of
the agents that respawn drawn beside them.

Set-up builds the env through the program's public entry point
(``megastep_tpu_torch.envs.<env>``) on the configuration's plans, in an order
drawn from the seed, resets it, and warms up. The window steps it for
``seconds`` and records a CUDA event after every step. From the window it
keeps, by reservoir sampling drawn from the seed, ``kept_steps`` steps (their
inputs, the state before, the state and world after) and always the last:
holding a reference costs the window nothing. Once the window has closed,
the plain reference builds the world again from the plans and the seed, and
is compared with the program's scenery, its reset, and each kept step,
worked from the program's state before that step.
"""
import numpy as np
import torch

from benchmark import common
from benchmark.counts import work
from benchmark.inputs import floorplans
from benchmark.reference import world as ref

WARMUP_STEPS = 16
TRACED_STEPS = 48
BLOCK_RAYS = 2**25  # (env, agent, ray, line) elements the reference takes at once


def _inputs(c, seed):
    cfg, traffic = c['config'], c['traffic']
    s_plans, s_scene, s_draws, s_keep = common.seeds(seed, 4)
    n_agents = cfg['n_agents']
    n_scenes = traffic['agent_envs'] // n_agents
    plans = floorplans.arranged(cfg['plans'], cfg['plan_seed'], n_scenes, s_plans)
    return plans, s_scene, s_draws, s_keep


def build(c, seed, device):
    """The program's env on the cell's plans, reset, and the draws' generator."""
    from megastep_tpu_torch import envs
    cfg = c['config']
    plans, s_scene, s_draws, s_keep = _inputs(c, seed)
    cls = getattr(envs, cfg['env'])
    kwargs = dict(geometries=plans, subsample=cfg['subsample'], res=cfg['res'],
                  fov=cfg['fov'], random=np.random.RandomState(s_scene), device=device)
    if cfg['n_agents'] > 1:
        kwargs['n_agents'] = cfg['n_agents']
    env = cls(c['traffic']['agent_envs'], **kwargs)
    gen = torch.Generator(device).manual_seed(s_draws)
    return env, gen, np.random.RandomState(s_keep)


def draws(env, gen, n_agents):
    """One step's inputs: actions (agent-envs, 1) in [0, 7) and spawn slots
    (scenes, agents) in [0, 100)."""
    n = env.n_envs
    actions = torch.randint(0, 7, (n, 1), generator=gen, device=gen.device)
    choices = torch.randint(0, 100, (n // n_agents, n_agents), generator=gen,
                            device=gen.device)
    return actions, choices


def _tree(f, *xs):
    if isinstance(xs[0], dict):
        return type(xs[0])({k: _tree(f, *(x[k] for x in xs)) for k in xs[0]})
    return f(*xs)


def _unchanged(before, state, world):
    return before, world


def _half(before, state, world):
    return _tree(lambda s, b: torch.cat([s[:len(s) // 2], b[len(s) // 2:]]),
                 state, before), world


def _alter(before, state, world):
    obs = world.obs.copy()
    obs['rgb'] = obs.rgb.clone()
    obs.rgb[0] += .5
    world = world.copy()
    world['obs'] = obs
    return state, world


#: Faults planted in the step, for the benchmark's own test of its check: the
#: state returned unchanged; the second half of the envs left unstepped; one
#: env's observation altered where it is produced.
FAULTS = dict(unchanged=_unchanged, half=_half, alter=_alter)


class Loop:
    """The closed loop over the program's env, keeping its reservoir."""

    def __init__(self, env, gen, keep_random, n_kept, n_agents, fault=None):
        from megastep_tpu_torch.arrdict import arrdict
        self.arrdict = arrdict
        self.env, self.gen, self.keep_random = env, gen, keep_random
        self.n_kept, self.n_agents, self.fault = n_kept, n_agents, FAULTS.get(fault)
        self.kept, self.last, self.seen = [], None, 0
        choices = torch.randint(0, 100, (env.n_envs // n_agents, n_agents), generator=gen,
                                device=gen.device)
        self.state, self.world = env.reset(choices)
        self.start = (choices, self.state, self.world)

    def step(self):
        actions, choices = draws(self.env, self.gen, self.n_agents)
        before = self.state
        state, world = self.env.step(before, self.arrdict(actions=actions), choices)
        if self.fault is not None:
            state, world = self.fault(before, state, world)
        record = (before, actions, choices, state, world)
        self.state, self.world = state, world
        # Reservoir sampling: every step is kept with equal chance.
        self.seen += 1
        if len(self.kept) < self.n_kept:
            self.kept.append(record)
        else:
            j = self.keep_random.randint(self.seen)
            if j < self.n_kept:
                self.kept[j] = record
        self.last = record


def run(c, seed, seconds, trace, device, t_start, fault=None):
    """One run of the cell. Returns the driver's part of the result."""
    traffic, cfg = c['traffic'], c['config']
    n_agents = cfg['n_agents']
    env, gen, keep_random = build(c, seed, device)
    loop = Loop(env, gen, keep_random, traffic['kept_steps'], n_agents, fault)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    Event = torch.cuda.Event if device == 'cuda' else _HostEvent

    # Warm up the window's own work, the reservoir's holding of steps included,
    # so that the allocator holds what the window needs.
    for _ in range(max(WARMUP_STEPS, traffic['kept_steps'] + 2)):
        loop.step()
    loop.kept, loop.last, loop.seen = [], None, 0
    events = [Event(enable_timing=True) for _ in range(traffic['max_steps'] + 1)]
    for e in events:
        e.record()  # creates each event now, not inside the window
    sync()
    setup_s = common.now() - t_start

    t0 = common.now()
    events[0].record()
    steps = 0
    while steps < traffic['max_steps']:
        loop.step()
        steps += 1
        events[steps].record()
        if common.now() - t0 >= seconds:
            break
    sync()
    window_s = common.now() - t0
    if steps >= traffic['max_steps']:
        raise RuntimeError(f'the window ran out of its {traffic["max_steps"]} events')
    periods = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    print(f'window: {steps} steps in {window_s:.3f} s; step_ms_p99.step over {len(periods)} '
          f'step periods', flush=True)

    n = env.n_envs
    out = dict(attempted=steps, failed=0,
               metrics=common.step_metrics(n, periods, window_s, setup_s),
               records=dict(window_s=window_s, steps=steps, n=n,
                            step_ms_p99=common.percentile(periods, 99)))
    if trace:
        # Device activity alone first (the idle share, the kernels' times),
        # then with the host's (what the host did in each idle gap).
        for key, host in (('trace', False), ('host_trace', True)):
            _, out['records'][key] = common.traced(
                lambda: [loop.step() for _ in range(TRACED_STEPS)], host)
            t0, t1 = out['records'][key]['span']
            out['records'][f'{key}_step_ms'] = 1e-3 * (t1 - t0) / TRACED_STEPS
    out['memory_peak_bytes'] = (torch.cuda.max_memory_allocated()
                                if device == 'cuda' else 0)

    # The program's env goes, but for the scenery and the kept steps judged.
    scenery = env.core.scenery
    kept = loop.kept + ([loop.last] if loop.last is not None else [])
    start = loop.start
    del env, loop, events
    if device == 'cuda':
        torch.cuda.empty_cache()
    numbers, work_counts = check(c, seed, device, scenery, start, kept)
    out['checks'] = numbers
    out['records'].update(work_counts)
    return out


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU, for the tests."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = common.now()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


SCENERY = ('lines', 'lines_width', 'lights', 'lights_width', 'textures', 'tex_width',
           'baked', 'line_tex_starts', 'line_tex_widths', 'tex_line')


def reference_world(c, seed, device):
    """The plain reference's world from the cell's plans and seed."""
    cfg = c['config']
    plans, s_scene, _, _ = _inputs(c, seed)
    order = ref.scene_order(plans, cfg['n_agents'])
    return ref.build([plans[i] for i in order], cfg['n_agents'],
                     np.random.RandomState(s_scene), device, cfg['res'], cfg['fov'],
                     cfg['subsample'])


def _blocks(world):
    N, L = world['lines'].shape[:2]
    per_env = world['n_agents'] * world['res'] * L
    size = max(1, BLOCK_RAYS // per_env)
    return [(n0, min(n0 + size, N)) for n0 in range(0, N, size)]


def _slice_state(state, n0, n1):
    if isinstance(state, dict):
        return {k: _slice_state(v, n0, n1) for k, v in state.items()}
    return state[n0:n1]


def _floats(x, dtype):
    if isinstance(x, dict):
        return {k: _floats(v, dtype) for k, v in x.items()}
    return x.to(dtype) if x.is_floating_point() else x


def reference_step(world, kind, before, actions, choices, dtype=torch.float32):
    """The reference's step from the program's state ``before``, in blocks of
    envs; outputs in float32."""
    A = world['n_agents']
    fn = ref.explorer_step if kind == 'Explorer' else ref.deathmatch_step
    states, worlds, hits = [], [], 0
    for n0, n1 in _blocks(world):
        w = ref.slice_envs(world, n0, n1)
        s, o, rc = fn(w, _floats(_slice_state(before, n0, n1), dtype),
                      actions[n0 * A:n1 * A], choices[n0:n1])
        states.append(_floats(s, torch.float32))
        worlds.append(_floats(o, torch.float32))
        hits += int((rc['indices'] >= 0).sum())
    return _cat(states), _cat(worlds), hits


def reference_reset(world, kind, choices):
    fn = ref.explorer_reset if kind == 'Explorer' else ref.deathmatch_reset
    states, worlds = [], []
    for n0, n1 in _blocks(world):
        s, o = fn(ref.slice_envs(world, n0, n1), choices[n0:n1])
        states.append(s)
        worlds.append(o)
    return _cat(states), _cat(worlds)


def _cat(xs):
    if isinstance(xs[0], dict):
        return {k: _cat([x[k] for x in xs]) for k in xs[0]}
    return torch.cat(xs, 0)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}{k}.')
    else:
        yield prefix[:-1], tree


def compare(prog_state, prog_world, ref_state, ref_world):
    """``(obs values off, state values off)``: the observations, and the next
    state with the reward and the reset flags."""
    obs = sum(common.mismatches(prog_world['obs'][k], v)
              for k, v in ref_world['obs'].items())
    rest = {'state': ref_state, 'reward': ref_world['reward'], 'reset': ref_world['reset']}
    prog = {'state': prog_state, 'reward': prog_world['reward'], 'reset': prog_world['reset']}
    prog_leaves = dict(_leaves(prog))
    state = sum(common.mismatches(prog_leaves[k], v) for k, v in _leaves(rest))
    return obs, state


def check(c, seed, device, scenery, start, kept):
    """The numbers compared for ``correct``: the scenery's largest gap, and
    the most observation and state values that the reset or any kept step got
    wrong. Also the work of the last kept step's observe, for the roofline."""
    kind = c['config']['env']
    world = reference_world(c, seed, device)
    gap = 0.
    for k in SCENERY:
        p, r = getattr(scenery, k), world[k]
        if p.shape != r.shape:
            gap = float('inf')
        elif r.is_floating_point():
            gap = max(gap, float((p.float() - r).abs().max()))
        elif bool((p != r).any()):
            gap = float('inf')
    del scenery

    choices, s0, w0 = start
    rs, rw = reference_reset(world, kind, choices)
    obs_off, state_off = compare(s0, w0, rs, rw)
    hits = 0
    for before, actions, choices, state, out in kept:
        rs, rw, hits = reference_step(world, kind, before, actions, choices)
        o, s = compare(state, out, rs, rw)
        obs_off, state_off = max(obs_off, o), max(state_off, s)
    N, A, nd = world['lines'].shape[0], world['n_agents'], world['n_dynamic']
    skip = nd if kind == 'Explorer' else 0
    live = int((world['lines_width'] - skip).sum())
    t_dyn = world['n_dynamic_texels'] if kind == 'Deathmatch' else 0
    seen = world['tex_line'].numel() if kind == 'Explorer' else None
    nbytes, ops = work.observe(N, A, world['res'], live, hits, t_dyn, seen)
    counts = dict(observe_bound_ms=work.roofline_ms(nbytes, ops), step_ops=ops)
    if kind == 'Deathmatch':
        counts['step_ops'] += int(work.rebake(t_dyn, world['lights_width'].long(),
                                              (world['lines_width'] - nd).long()).sum())
    numbers = [('scenery_gap', gap), ('obs_mismatch', obs_off),
               ('state_mismatch', state_off)]
    return numbers, counts
