"""A Granite-4.0-H hybrid core: Mamba-2 state-space mixers and GQA memory
attention with no positional embedding.

The block is IBM's ``GraniteMoeHybrid`` (``granite-4.0-h-micro``) with no
experts. Each layer is

    h = h + r·mixer(rmsnorm(h))
    h = h + r·mlp(rmsnorm(h))

with ``r`` the residual multiplier, ``mixer`` a Mamba-2 mixer or the attention
as ``layer_types`` says, ``mlp`` the shared SwiGLU, and a final RMSNorm. The
core's input (the intake's output) is scaled by the embedding multiplier.

The Mamba-2 mixer (``in_proj`` → ``[z | xBC | dt]``; a causal depthwise conv
over ``xBC``, then SiLU, split into x, B, C; ``dt = softplus(dt + dt_bias)``,
``A = −exp(A_log)``)::

    S_t = exp(dt_t·A)·S_{t−1} + dt_t·x_t⊗B_t,    y_t = S_t·C_t + D·x_t

then ``out_proj(rmsnorm(y·silu(z)))``. One step (T=1, the rollout) runs the
recurrence as it is (:func:`ssm_step`); a chunk (T>1, the learner) runs the
chunked form of state-space duality over the whole chunk (:func:`ssm_chunk`),
which keeps no per-step state for autograd. A reset at ``t`` cuts the scan
before ``t`` (``S_{t−1}`` taken as zero) and the conv's window (the inputs
before ``t`` taken as zero); an episode boundary inside a chunk plays the part
of a document boundary in a packed sequence.

The attention is grouped-query attention over a detached ``[memory, chunk]``
window of keys and values, with :func:`~.transformer.visibility`'s reset-aware
mask. With no relative positions, the memory holds keys and values, not
inputs.

State is an arrdict, batch-first, per layer ``layer<i>``: a Mamba layer's
``ssm`` (B, H, P, N) and ``conv`` (B, K−1, conv width), the conv inputs of the
last K−1 steps with those before a reset zeroed; the attention layer's ``k``,
``v`` (B, mem_len, KV heads, head size), ``reset`` and ``valid`` (B, mem_len),
as in :meth:`~.transformer.Transformer.initial_state`. No operation syncs with
the host or takes a shape that depends on data, so a CUDA graph can hold the
chunked form.

Fresh parameters take the port's distributions (:mod:`.init`'s
``lecun_normal``) for the projections and the conv, and Granite's for the
rest: ``A_log = log(1..H)``, ``D = 1``, ``dt_bias = 1``, norm weights 1.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

from .. import tracing
from ..arrdict import arrdict
from .init import TRUNCATED_STD
from .transformer import visibility


def lecun_normal_(weight, fan_in, generator=None):
    """:func:`.init.lecun_normal_`'s distribution (a normal truncated at two
    standard deviations, scaled to std ``sqrt(1/fan_in)``), drawn in one pass
    by the inverse of the normal CDF. PyTorch's ``trunc_normal_`` draws by
    rejection in recent versions, redrawing the whole tensor until no draw
    falls outside: several seconds for one of this core's weights."""
    lo, hi = ((1 + math.erf(x / math.sqrt(2))) / 2 for x in (-2., 2.))
    scale = math.sqrt(1 / fan_in) / TRUNCATED_STD
    with torch.no_grad():
        weight.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator).erfinv_()
        return weight.mul_(math.sqrt(2) * scale).clamp_(-2 * scale, 2 * scale)


def linear(d_in, d_out, bias=True, generator=None):
    """A ``Linear`` initialised as :func:`.init.linear`, drawn by
    :func:`lecun_normal_` (and not first by PyTorch's own initialiser)."""
    layer = nn.Linear(d_in, d_out, bias=bias, device='meta').to_empty(device='cpu')
    lecun_normal_(layer.weight, d_in, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


#: ``granite-4.0-h-micro``'s first period of ten layers: five Mamba layers,
#: one attention layer, four Mamba layers (the published ``layer_types[:10]``).
MICRO_LAYERS = ('mamba',) * 5 + ('attention',) + ('mamba',) * 4


class RMSNorm(nn.Module):
    def __init__(self, width, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x, gate=None):
        """RMSNorm of ``x``, or with ``gate`` Mamba-2's gated form, the norm of
        ``x·silu(gate)``."""
        if gate is not None:
            x = x * F.silu(gate)
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def causal_conv(x, reset, window, weight, bias):
    """The causal depthwise conv over ``x`` (T, B, C), its window carried.

    :param window: (B, K−1, C) the inputs of the K−1 steps before ``x``, those
        before a reset already zeroed.
    :param weight: (C, 1, K), as ``nn.Conv1d`` holds it; ``bias``: (C,) or None.
    :return: ``(out, window)``: the conv's output (T, B, C), where the taps
        before the latest reset at or before each step read zero, and the new
        window, the last K−1 inputs with those before the chunk's last reset
        zeroed.
    """
    T, K = x.shape[0], weight.shape[-1]
    cat = torch.cat([window.transpose(0, 1), x], 0)             # (K−1+T, B, C)
    zeros = torch.zeros((K - 1,) + reset.shape[1:], dtype=torch.int32, device=x.device)
    count = torch.cat([zeros, reset.int().cumsum(0, dtype=torch.int32)], 0)
    w = weight[:, 0]                                             # (C, K)
    out = x * w[:, K - 1] if bias is None else torch.addcmul(bias, x, w[:, K - 1])
    for lag in range(1, K):
        tap = cat[K - 1 - lag:K - 1 - lag + T]
        same = (count[K - 1 - lag:K - 1 - lag + T] == count[K - 1:])[..., None]
        out = out + torch.where(same, tap, 0.) * w[:, K - 1 - lag]
    kept = (count[T:] == count[-1])[..., None]
    return out, torch.where(kept, cat[T:], 0.).transpose(0, 1)


def ssm_step(ssm, x, dt, A, B, C, reset):
    """One step of the scan: ``S = exp(dt·A)·S + dt·x⊗B`` (``S`` zeroed first
    where ``reset``), ``y = S·C``.

    :param ssm: (B, H, P, N); :param x: (B, H, P); :param dt: (B, H);
        :param A: (H,); :param B, C: (B, N) (one group); :param reset: (B,).
    :return: ``(y, ssm)``, y (B, H, P).
    """
    decay = torch.where(reset[:, None], 0., torch.exp(dt * A))
    s = ssm * decay[..., None, None]
    s.addcmul_((dt[..., None] * x)[..., None], B[:, None, None, :])
    return torch.matmul(s, C[:, None, :, None])[..., 0], s


def ssm_chunk(ssm, x, dt, A, B, C, reset):
    """The scan over a chunk in its chunked (state-space duality) form: the
    chunk's own terms as a masked (T, T) product, the start state's through
    the decays from the start.

    ``L[t, s]``, the decay from step ``s`` to ``t``, is ``exp`` of the sum of
    ``dt·A`` over ``(s, t]``, taken directly for each pair (so no difference of
    two long sums loses the short ones' precision), and zero where a reset lies
    in ``(s, t]``. The new state is computed without autograd: it leaves the
    call detached.

    :param ssm: (B, H, P, N) start state; :param x: (T, B, H, P); :param dt:
        (T, B, H); :param A: (H,); :param B, C: (T, B, N); :param reset: (T, B).
    :return: ``(y, ssm)``, y (T, B, H, P).
    """
    T = x.shape[0]
    a = (dt * A).permute(1, 2, 0)                                # (B, H, T)
    rows = torch.arange(T, device=x.device)
    below = rows[:, None] > rows[None]                           # s < t
    seg = torch.where(below, a[..., None], 0.).cumsum(-2)        # [t, s]: sum over (s, t]
    count = reset.int().cumsum(0, dtype=torch.int32).T           # (B, T), inclusive
    same = (count[:, :, None] == count[:, None, :]) & (rows[:, None] >= rows[None])
    decay = torch.where(same[:, None], torch.exp(seg), 0.)       # (B, H, T, T)
    start = torch.where((count == 0)[:, None], torch.exp(a.cumsum(-1)), 0.)  # (B, H, T)

    dt_s = dt.permute(1, 2, 0)[:, :, None, :]                    # (B, H, 1, T)
    weights = decay * torch.einsum('tbn,sbn->bts', C, B)[:, None] * dt_s
    y = torch.einsum('bhts,sbhp->tbhp', weights, x)
    y = y + torch.einsum('bhpn,tbn->tbhp', ssm, C) * start.permute(2, 0, 1)[..., None]
    with torch.no_grad():
        xw = x * (decay[:, :, -1] * dt_s[:, :, 0]).permute(2, 0, 1)[..., None]
        new = ssm * start[:, :, -1, None, None] + torch.einsum('sbhp,sbn->bhpn', xw, B)
    return y, new


class Mamba2(nn.Module):
    """The Mamba-2 mixer of one group (``mamba_n_groups`` 1)."""

    def __init__(self, d_model, expand=2, n_heads=64, d_head=64, d_state=128, n_groups=1,
                 d_conv=4, conv_bias=True, proj_bias=False, eps=1e-5, generator=None):
        super().__init__()
        if n_groups != 1:
            raise ValueError(f'the mixer holds one group of B and C, not {n_groups}')
        inner = expand * d_model
        if n_heads * d_head != inner:
            raise ValueError(f'{n_heads} heads of {d_head} do not make the inner width {inner}')
        self.inner, self.n_heads, self.d_head, self.d_state = inner, n_heads, d_head, d_state
        self.d_conv, self.conv_width = d_conv, inner + 2 * d_state
        self.in_proj = linear(d_model, inner + self.conv_width + n_heads, bias=proj_bias,
                              generator=generator)
        self.conv1d = nn.Conv1d(self.conv_width, self.conv_width, d_conv, groups=self.conv_width,
                                bias=conv_bias, device='meta').to_empty(device='cpu')
        lecun_normal_(self.conv1d.weight, d_conv, generator)
        if conv_bias:
            nn.init.zeros_(self.conv1d.bias)
        self.dt_bias = nn.Parameter(torch.ones(n_heads))
        self.A_log = nn.Parameter(torch.log(torch.arange(1., n_heads + 1)))
        self.D = nn.Parameter(torch.ones(n_heads))
        self.norm = RMSNorm(inner, eps)
        self.out_proj = linear(inner, d_model, bias=proj_bias, generator=generator)

    def initial_state(self, batch, device=None, dtype=torch.float32):
        return arrdict(
            ssm=torch.zeros((batch, self.n_heads, self.d_head, self.d_state), dtype=dtype,
                            device=device),
            conv=torch.zeros((batch, self.d_conv - 1, self.conv_width), dtype=dtype,
                             device=device))

    def forward(self, u, reset, state):
        with tracing.span('core.mamba'):
            T, Bt = u.shape[:2]
            H, P, N = self.n_heads, self.d_head, self.d_state
            z, xBC, dt = self.in_proj(u).split([self.inner, self.conv_width, H], -1)
            xBC, conv = causal_conv(xBC, reset, state.conv, self.conv1d.weight,
                                    self.conv1d.bias)
            x, B, C = F.silu(xBC).split([self.inner, N, N], -1)
            x = x.reshape(T, Bt, H, P)
            dt = F.softplus(dt + self.dt_bias)
            A = -torch.exp(self.A_log)
            if T == 1:
                y, ssm = ssm_step(state.ssm, x[0], dt[0], A, B[0], C[0], reset[0])
                y = y[None]
                tracing.count('ssm_state_bytes', 2 * (ssm.numel() * ssm.element_size()
                                                      + conv.numel() * conv.element_size()))
            else:
                y, ssm = ssm_chunk(state.ssm, x, dt, A, B, C, reset)
            y = (y + self.D[:, None] * x).reshape(T, Bt, self.inner)
            out = self.out_proj(self.norm(y, z))
        return out, arrdict(ssm=ssm.detach(), conv=conv.detach())


class Attention(nn.Module):
    """Grouped-query attention with no positional embedding over a memory of
    the last ``mem_len`` keys and values (each query sees itself and at most
    ``mem_len − 1`` earlier steps of its own episode)."""

    def __init__(self, d_model, n_heads=32, n_kv_heads=8, d_head=64, multiplier=1 / 64,
                 mem_len=512, bias=False, generator=None):
        super().__init__()
        if n_heads % n_kv_heads:
            raise ValueError(f'{n_heads} query heads do not split over {n_kv_heads} KV heads')
        self.n_heads, self.n_kv_heads, self.d_head = n_heads, n_kv_heads, d_head
        self.multiplier, self.mem_len = multiplier, mem_len
        self.q_proj = linear(d_model, n_heads * d_head, bias=bias, generator=generator)
        self.k_proj = linear(d_model, n_kv_heads * d_head, bias=bias, generator=generator)
        self.v_proj = linear(d_model, n_kv_heads * d_head, bias=bias, generator=generator)
        self.o_proj = linear(n_heads * d_head, d_model, bias=bias, generator=generator)

    def initial_state(self, batch, device=None, dtype=torch.float32):
        kv = (batch, self.mem_len, self.n_kv_heads, self.d_head)
        return arrdict(
            k=torch.zeros(kv, dtype=dtype, device=device),
            v=torch.zeros(kv, dtype=dtype, device=device),
            reset=torch.zeros((batch, self.mem_len), dtype=torch.bool, device=device),
            valid=torch.zeros((batch, self.mem_len), dtype=torch.bool, device=device))

    def forward(self, u, reset, state):
        with tracing.span('core.attention'):
            T, B = u.shape[:2]
            KV, Dh, M = self.n_kv_heads, self.d_head, self.mem_len
            G = self.n_heads // KV
            q = self.q_proj(u).reshape(T, B, KV, G, Dh)
            k = torch.cat([state.k, self.k_proj(u).reshape(T, B, KV, Dh).transpose(0, 1)], 1)
            v = torch.cat([state.v, self.v_proj(u).reshape(T, B, KV, Dh).transpose(0, 1)], 1)
            vis = visibility(state.reset.T, state.valid.T, reset, M)     # (T, M+T, B)
            score = torch.einsum('tbkgd,bjkd->bkgtj', q, k) * self.multiplier
            score = score.masked_fill(~vis.permute(2, 0, 1)[:, None, None], -math.inf)
            prob = torch.softmax(score, -1)
            out = torch.einsum('bkgtj,bjkd->tbkgd', prob, v).reshape(T, B, KV * G * Dh)
            out = self.o_proj(out)
            ones = torch.ones((B, T), dtype=torch.bool, device=u.device)
            new = arrdict(k=k[:, -M:].detach(), v=v[:, -M:].detach(),
                          reset=torch.cat([state.reset, reset.T], 1)[:, -M:],
                          valid=torch.cat([state.valid, ones], 1)[:, -M:])
        return out, new


class MLP(nn.Module):
    """The shared SwiGLU: ``output_linear(silu(a)·b)``, ``[a | b] = input_linear(x)``."""

    def __init__(self, d_model, width, generator=None):
        super().__init__()
        self.input_linear = linear(d_model, 2 * width, bias=False, generator=generator)
        self.output_linear = linear(width, d_model, bias=False, generator=generator)

    def forward(self, x):
        a, b = self.input_linear(x).chunk(2, -1)
        return self.output_linear(F.silu(a) * b)


class Layer(nn.Module):
    def __init__(self, mixer, d_model, mlp_width, eps, residual, generator=None):
        super().__init__()
        self.residual = residual
        self.input_layernorm = RMSNorm(d_model, eps)
        self.mixer = mixer
        self.post_attention_layernorm = RMSNorm(d_model, eps)
        self.shared_mlp = MLP(d_model, mlp_width, generator)

    def forward(self, h, reset, state):
        m, state = self.mixer(self.input_layernorm(h), reset, state)
        h = h + self.residual * m
        return h + self.residual * self.shared_mlp(self.post_attention_layernorm(h)), state


class HybridCore(nn.Module):
    """The hybrid stack over (T, B, d_model) inputs. Call signature matches
    :class:`~.lstm.LSTM`: ``(x, reset, state) -> (y, new_state)``. The keyword
    arguments are the published configuration's names, and their defaults
    ``granite-4.0-h-micro``'s, at its first period of ten layers; ``mem_len``
    is the attention memory's slots."""

    def __init__(self, d_model, layer_types=MICRO_LAYERS, mamba_expand=2, mamba_n_heads=64,
                 mamba_d_head=64, mamba_d_state=128, mamba_n_groups=1, mamba_d_conv=4,
                 mamba_conv_bias=True, mamba_proj_bias=False, num_attention_heads=32,
                 num_key_value_heads=8, attention_multiplier=1 / 64, attention_bias=False,
                 shared_intermediate_size=8192, rms_norm_eps=1e-5, residual_multiplier=.22,
                 embedding_multiplier=12., mem_len=512, generator=None):
        super().__init__()
        self.layer_types, self.embedding_multiplier = tuple(layer_types), embedding_multiplier
        layers = []
        for kind in self.layer_types:
            if kind == 'mamba':
                mixer = Mamba2(d_model, mamba_expand, mamba_n_heads, mamba_d_head, mamba_d_state,
                               mamba_n_groups, mamba_d_conv, mamba_conv_bias, mamba_proj_bias,
                               rms_norm_eps, generator)
            elif kind == 'attention':
                mixer = Attention(d_model, num_attention_heads, num_key_value_heads,
                                  d_model // num_attention_heads, attention_multiplier, mem_len,
                                  attention_bias, generator)
            else:
                raise ValueError(f'Unknown layer type {kind!r}')
            layers.append(Layer(mixer, d_model, shared_intermediate_size, rms_norm_eps,
                                residual_multiplier, generator))
        self.layers = nn.ModuleList(layers)
        self.norm = RMSNorm(d_model, rms_norm_eps)

    def initial_state(self, batch, device=None, dtype=torch.float32):
        return arrdict({f'layer{i}': layer.mixer.initial_state(batch, device, dtype)
                        for i, layer in enumerate(self.layers)})

    def forward(self, x, reset, state):
        h = x * self.embedding_multiplier
        new_state = arrdict()
        for i, layer in enumerate(self.layers):
            h, new_state[f'layer{i}'] = layer(h, reset, state[f'layer{i}'])
        return self.norm(h), new_state
