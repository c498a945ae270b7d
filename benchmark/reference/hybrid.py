"""The plain reference of the hybrid agent: the demo agent's intakes and heads
around a Granite-4.0-H hybrid core (``granite-4.0-h-micro``, IBM's
``GraniteMoeHybrid`` with no experts), the core a step-by-step loop over time
with explicit resets, in float32.

The core, per layer: ``h = h + r·mixer(rmsnorm(h))``, ``h = h + r·mlp(rmsnorm(h))``,
then a final RMSNorm. The Mamba-2 mixer at each step::

    [z | xBC | dt] = in_proj(u);  xBC = silu(conv1d over the last d_conv xBC, + bias)
    [x | B | C] = xBC;  dt = softplus(dt + dt_bias);  A = −exp(A_log)
    S = exp(dt·A)·S + dt·x⊗B;  y = S·C + D·x;  out = out_proj(rmsnorm(y·silu(z)))

The attention layer: grouped-query attention with no positional embedding,
scaled by ``attention_multiplier``. The MLP: ``output_linear(silu(a)·b)``,
``[a | b] = input_linear(x)``.

Departures from the published model, as the configuration states them: no
embedding, vocabulary or LM head (the intake's output, scaled by
``embedding_multiplier``, is the core's input; the policy and value heads take
the LM head's place, and ``logits_scaling`` is not applied); a reset (an
episode boundary) zeroes the SSM state and the conv window before its step and
hides every earlier key from the attention; the attention sees a memory of the
last ``mem_len`` steps, itself included; float32 for the published bfloat16.

It is given the program's parameters (a dict of tensors under the program's
names) and the program's state, which :func:`from_program_state` reads: per
Mamba layer ``ssm`` and ``conv`` (the last ``d_conv − 1`` conv inputs), per
attention layer ``k``, ``v`` and ``live``, the memory slots later steps may
still see (filled, and no later slot began an episode). The intakes are
``agent.Intake``, run on the program's parameters. Imports nothing of the
program.
"""
import torch
from torch.func import functional_call
from torch.nn import functional as F

from benchmark.reference import agent as ref_agent


def rmsnorm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _linear(p, name, x):
    y = x @ p[f'{name}.weight'].T
    return y if p.get(f'{name}.bias') is None else y + p[f'{name}.bias']


def _sub(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def mamba_step(p, cfg, u, reset, state):
    """One Mamba-2 step of a (B, d) input; ``reset`` (B,) zeroes the state and
    the conv window first."""
    H, P, N = cfg['mamba_n_heads'], cfg['mamba_d_head'], cfg['mamba_d_state']
    inner = H * P
    z, xBC, dt = _linear(p, 'in_proj', u).split([inner, inner + 2 * N, H], -1)
    keep = (~reset).float()
    window = torch.cat([state['conv'] * keep[:, None, None], xBC[:, None]], 1)
    conv = (window * p['conv1d.weight'][:, 0].T).sum(1)
    if p.get('conv1d.bias') is not None:
        conv = conv + p['conv1d.bias']
    x, B, C = F.silu(conv).split([inner, N, N], -1)
    x = x.reshape(-1, H, P)
    dt = F.softplus(dt + p['dt_bias'])
    A = -torch.exp(p['A_log'])
    S = state['ssm'] * keep[:, None, None, None]
    S = (torch.exp(dt * A)[..., None, None] * S
         + (dt[..., None] * x)[..., None] * B[:, None, None, :])
    y = (S * C[:, None, None, :]).sum(-1) + p['D'][:, None] * x
    y = y.reshape(-1, inner) * F.silu(z)
    out = _linear(p, 'out_proj', rmsnorm(y, p['norm.weight'], cfg['rms_norm_eps']))
    return out, dict(ssm=S, conv=window[:, 1:])


def attention_step(p, cfg, u, reset, state):
    """One step of memory attention: on a reset every remembered key is
    hidden; the step's key and value replace the oldest; the query attends
    over what is live."""
    NH, KV = cfg['num_attention_heads'], cfg['num_key_value_heads']
    Dh = u.shape[-1] // NH
    B = u.shape[0]
    q = _linear(p, 'q_proj', u).reshape(B, NH, Dh)
    k = _linear(p, 'k_proj', u).reshape(B, 1, KV, Dh)
    v = _linear(p, 'v_proj', u).reshape(B, 1, KV, Dh)
    live = state['live'] & ~reset[:, None]
    keys = torch.cat([state['k'][:, 1:], k], 1)
    values = torch.cat([state['v'][:, 1:], v], 1)
    live = torch.cat([live[:, 1:], torch.ones_like(live[:, :1])], 1)
    group = torch.arange(NH, device=u.device) // (NH // KV)
    score = (q[:, None] * keys[:, :, group]).sum(-1) * cfg['attention_multiplier']
    prob = torch.softmax(torch.where(live[..., None], score, -torch.inf), 1)
    out = (prob[..., None] * values[:, :, group]).sum(1).reshape(B, NH * Dh)
    return _linear(p, 'o_proj', out), dict(k=keys, v=values, live=live)


def core(params, cfg, x, reset, state):
    """The core over a (T, B, d) chunk, one step at a time; ``params`` under
    the core's own names (``layers.<i>.mixer.in_proj.weight``, ...)."""
    r, eps = cfg['residual_multiplier'], cfg['rms_norm_eps']
    layers = [(kind, _sub(params, f'layers.{i}.')) for i, kind in enumerate(cfg['layer_types'])]
    mixers = [_sub(p, 'mixer.') for _, p in layers]
    state = dict(state)
    ys = []
    for t in range(x.shape[0]):
        h = x[t] * cfg['embedding_multiplier']
        for i, ((kind, p), mix) in enumerate(zip(layers, mixers)):
            step = mamba_step if kind == 'mamba' else attention_step
            m, state[f'layer{i}'] = step(mix, cfg, rmsnorm(h, p['input_layernorm.weight'], eps),
                                         reset[t], state[f'layer{i}'])
            h = h + r * m
            g = rmsnorm(h, p['post_attention_layernorm.weight'], eps)
            a, b = (g @ p['shared_mlp.input_linear.weight'].T).chunk(2, -1)
            h = h + r * ((F.silu(a) * b) @ p['shared_mlp.output_linear.weight'].T)
        ys.append(rmsnorm(h, params['norm.weight'], eps))
    return torch.stack(ys), state


def from_program_state(cfg, state):
    """One core's state, as the program holds it, in the reference's terms."""
    out = {}
    for i, kind in enumerate(cfg['layer_types']):
        s = state[f'layer{i}']
        if kind == 'mamba':
            out[f'layer{i}'] = dict(ssm=s['ssm'], conv=s['conv'])
        else:
            later = s['reset'].flip(1).int().cumsum(1).flip(1) - s['reset'].int()
            out[f'layer{i}'] = dict(k=s['k'], v=s['v'], live=s['valid'] & (later == 0))
    return out


class Agent:
    """The hybrid agent on given parameters: for the policy and the value
    each, the intake (``agent.Intake``), the core, and a dense head (to a
    log-softmax over ``n_actions`` per agent, or to a scalar).

    :param cfg: the configuration (the core's published names, ``mem_len``
        and ``hidden_size``).
    """

    def __init__(self, obs_shapes, n_agents, n_actions, cfg):
        self.cfg, self.shape = cfg, (n_agents, n_actions)
        # Built once for its forward; its own parameters are never used.
        self.intake = ref_agent.Intake(obs_shapes, cfg['hidden_size'], torch.Generator())

    def __call__(self, params, obs, reset, state):
        """Over a (T, B, ...) chunk from ``state`` (the program's form).

        :return: ``(logits, value, new_state)``, the state in the reference's
            terms.
        """
        cfg, new = self.cfg, {}
        out = {}
        for side in ('policy', 'value'):
            x = functional_call(self.intake, _sub(params, f'{side}_intake.'), (obs,))
            y, new[side] = core(_sub(params, f'{side}_core.'), cfg, x, reset,
                                from_program_state(cfg, state[side]))
            out[side] = _linear(params, f'{side}_out.Dense_0', y)
        logits = F.log_softmax(out['policy'].reshape(*out['policy'].shape[:-1], *self.shape), -1)
        return logits, out['value'][..., 0], new
