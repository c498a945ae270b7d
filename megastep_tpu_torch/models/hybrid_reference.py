"""The plain reference of the Granite-4.0-H hybrid core: a step-by-step loop
over time, with explicit resets, in float32.

It follows IBM's ``GraniteMoeHybrid`` (the ``granite-4.0-h-micro`` config,
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json)
with no experts. Per layer, ``h = h + r·mixer(rmsnorm(h))``, then
``h = h + r·mlp(rmsnorm(h))``, and a final RMSNorm. The Mamba-2 mixer, at each
step ``t``::

    [z | xBC | dt] = in_proj(u_t)
    xBC = silu(conv1d over the last d_conv inputs of xBC, with bias)
    [x | B | C] = xBC;  dt = softplus(dt + dt_bias);  A = −exp(A_log)
    S_t = exp(dt·A)·S_{t−1} + dt·x⊗B;  y = S_t·C + D·x
    out = out_proj(rmsnorm(y·silu(z)))

The attention layer is grouped-query attention (each KV head serves
``num_attention_heads / num_key_value_heads`` query heads), scaled by
``attention_multiplier``, with no positional embedding.

Departures from the published model, each forced by its use as an agent's
recurrent core over rollout chunks:

* No embedding, vocabulary or LM head: the input is the agent's intake output,
  scaled by ``embedding_multiplier``; ``logits_scaling`` is not applied.
* A reset at step ``t`` (an episode boundary) zeroes the SSM state and the
  conv's window before the step, and hides from the attention every key of
  the episode before it, as separate documents of a packed sequence are cut.
* The attention sees a memory of the last ``mem_len`` steps, itself included,
  not the whole sequence: the memory holds keys and values.
* Fresh parameters (made by the port, not here) take the port's initialisers
  for the projections, not the published ``normal(0, 0.1)``.
* Float32 throughout, where the published weights are bfloat16.

The parameters are a dict of tensors under the port's names
(``layers.<i>.mixer.in_proj.weight``, ...). The state is the port's, batch-first,
taken in by :func:`from_port_state`: per Mamba layer ``ssm`` and ``conv`` (the
last ``d_conv − 1`` conv inputs), per attention layer ``k``, ``v`` and ``live``,
which keys later queries may still see. Imports nothing of the port.
"""
import torch
from torch.nn import functional as F


def rmsnorm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _sub(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _linear(p, name, x):
    y = x @ p[f'{name}.weight'].T
    return y if p.get(f'{name}.bias') is None else y + p[f'{name}.bias']


def mamba_step(p, cfg, u, reset, state):
    """One Mamba-2 step of a (B, d) input; ``reset`` (B,) zeroes the state
    and the conv window first."""
    H, P, N = cfg['mamba_n_heads'], cfg['mamba_d_head'], cfg['mamba_d_state']
    inner = H * P
    z, xBC, dt = _linear(p, 'in_proj', u).split([inner, inner + 2 * N, H], -1)
    keep = (~reset).float()
    window = torch.cat([state['conv'] * keep[:, None, None], xBC[:, None]], 1)  # (B, K, C)
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
    """One step of memory attention over a (B, d) input: on a reset every
    remembered key is hidden, then the step's key and value replace the
    oldest, and the query attends over what is live."""
    NH, KV = cfg['num_attention_heads'], cfg['num_key_value_heads']
    Dh = u.shape[-1] // NH
    B = u.shape[0]
    q = _linear(p, 'q_proj', u).reshape(B, NH, Dh)
    k = _linear(p, 'k_proj', u).reshape(B, 1, KV, Dh)
    v = _linear(p, 'v_proj', u).reshape(B, 1, KV, Dh)
    live = state['live'] & ~reset[:, None]
    keys = torch.cat([state['k'][:, 1:], k], 1)                 # (B, M, KV, Dh)
    values = torch.cat([state['v'][:, 1:], v], 1)
    live = torch.cat([live[:, 1:], torch.ones_like(live[:, :1])], 1)
    group = torch.arange(NH, device=u.device) // (NH // KV)
    score = (q[:, None] * keys[:, :, group]).sum(-1) * cfg['attention_multiplier']  # (B, M, NH)
    score = torch.where(live[..., None], score, -torch.inf)
    prob = torch.softmax(score, 1)
    out = (prob[..., None] * values[:, :, group]).sum(1).reshape(B, NH * Dh)
    return _linear(p, 'o_proj', out), dict(k=keys, v=values, live=live)


def core(params, cfg, x, reset, state):
    """The core over a (T, B, d) chunk, one step at a time.

    :param params: the core's parameters by the port's names.
    :param cfg: the configuration's sizes (the published names, and ``mem_len``).
    :param reset: (T, B) bool.
    :param state: per layer ``layer<i>``, as :func:`from_port_state` gives it.
    :return: ``(y, state)``, y (T, B, d).
    """
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


def from_port_state(cfg, state):
    """The port's state in the reference's terms: a memory slot is live if it
    was filled and no later slot began a new episode."""
    out = {}
    for i, kind in enumerate(cfg['layer_types']):
        s = state[f'layer{i}']
        if kind == 'mamba':
            out[f'layer{i}'] = dict(ssm=s['ssm'], conv=s['conv'])
        else:
            later = s['reset'].flip(1).int().cumsum(1).flip(1) - s['reset'].int()
            out[f'layer{i}'] = dict(k=s['k'], v=s['v'], live=s['valid'] & (later == 0))
    return out
