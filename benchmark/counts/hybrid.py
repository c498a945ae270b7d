"""The benchmark's frozen counts of the hybrid agent's work, computed from the
configuration's shapes, the same whatever implements the layers.

A Mamba-2 mixer's step on one sample: its projections (two operations a
multiply-add), the depthwise conv, and the scan's ``5·H·P·N``: the state's
decay (one multiply an element), the update ``dt·x⊗B`` (a multiply-add) and
the read-out ``S·C`` (a multiply-add). Its bytes in a one-step call on
``batch`` samples: every weight read once, the SSM and conv state read and
written once each, the input read and the output written once, in float32.
The attention layer counts its projections and, per query, the scores and the
weighted sum over a full memory of ``mem_len`` keys. Each layer's MLP counts
its two projections. The agent's count adds the intakes and heads of the
demo agent's frozen count (``work.agent``, less its two LSTM cores).
"""
from benchmark.counts import work

F32 = 4


def _mamba(cfg):
    H, P, N, K = (cfg['mamba_n_heads'], cfg['mamba_d_head'], cfg['mamba_d_state'],
                  cfg['mamba_d_conv'])
    inner = H * P
    conv = inner + 2 * cfg['mamba_n_groups'] * N
    return H, P, N, K, inner, conv, inner + conv + H


def mamba_params(cfg):
    """Parameters of one Mamba-2 mixer (biases as the configuration says)."""
    d = cfg['hidden_size']
    H, P, N, K, inner, conv, proj = _mamba(cfg)
    bias = cfg['mamba_proj_bias']
    return (d * proj + bias * proj + conv * K + cfg['mamba_conv_bias'] * conv + 3 * H + inner
            + inner * d + bias * d)


def mamba_flops(cfg):
    """FLOPs of one Mamba-2 mixer on one sample."""
    d = cfg['hidden_size']
    H, P, N, K, inner, conv, proj = _mamba(cfg)
    return 2 * d * proj + 2 * K * conv + 5 * H * P * N + 2 * inner * d


def state_bytes(cfg, batch):
    """Bytes of SSM and conv state that one one-step call of a Mamba-2 mixer
    on ``batch`` samples reads and writes."""
    H, P, N, K, inner, conv, proj = _mamba(cfg)
    return 2 * batch * (H * P * N + (K - 1) * conv) * F32


def mamba_step(cfg, batch):
    """``(bytes, FLOPs)`` of one one-step call of a Mamba-2 mixer on ``batch``
    samples."""
    d = cfg['hidden_size']
    nbytes = mamba_params(cfg) * F32 + state_bytes(cfg, batch) + 2 * batch * d * F32
    return nbytes, batch * mamba_flops(cfg)


def attention_flops(cfg):
    """FLOPs of the attention mixer on one sample over a full memory."""
    d, NH, KV = cfg['hidden_size'], cfg['num_attention_heads'], cfg['num_key_value_heads']
    Dh = d // NH
    return 2 * d * NH * Dh * 2 + 2 * 2 * d * KV * Dh + 2 * 2 * NH * Dh * cfg['mem_len']


def core_flops(cfg):
    """FLOPs of one core (the period's layers) on one sample."""
    d, F = cfg['hidden_size'], cfg['shared_intermediate_size']
    mixers = sum(mamba_flops(cfg) if kind == 'mamba' else attention_flops(cfg)
                 for kind in cfg['layer_types'])
    return mixers + len(cfg['layer_types']) * 6 * d * F


def agent(obs_shapes, n_actions, cfg):
    """FLOPs of one sample through the hybrid agent's forward (policy and
    value), and of the layers that take the observations.

    :return: ``(forward, first_layers)``, as ``work.agent``'s.
    """
    d = cfg['hidden_size']
    lstm_agent, first = work.agent(obs_shapes, n_actions, d)
    lstm = 2 * 2 * d * 4 * d
    return lstm_agent - 2 * lstm + 2 * core_flops(cfg), first


def mamba_roofline_ms(cfg, batch, calls):
    """The least time ``calls`` one-step calls of a Mamba-2 mixer on ``batch``
    samples could take on one H100, in ms."""
    nbytes, flops = mamba_step(cfg, batch)
    return calls * work.roofline_ms(nbytes, flops)
