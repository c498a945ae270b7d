"""A Transformer-XL-style memory core with GTrXL gating.

Counterpart of :mod:`megastep_tpu.models.transformer` (the reference
``megastep/demo/transformer.py``): recurrent activation memory spanning rollout
chunks, relative position scores, reset-aware masking so attention never crosses
episode boundaries, and GRU-type layer gating (GTrXL). As in the JAX package, the
memory is a fixed-length window of the last ``mem_len`` activations with a
validity mask, the reset mask comes from an inclusive cumulative reset count
over [memory, chunk], and relative position scores are gathered by distance.

State is an explicit arrdict, per layer the memory and its reset/validity flags,
batch-first: (B, mem_len, ...). LayerNorms take flax's epsilon, 1e-6.
"""
import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..arrdict import arrdict
from ..ops.geom import div
from .init import linear

LN_EPS = 1e-6


def frequencies(d_model, lim=1024):
    """The embedding's angular frequencies, in float64 (a numpy array)."""
    return 2 * np.pi / (lim ** (np.arange(0., d_model, 2.) / d_model))


def positional_embedding(pos, d_model, lim=1024, inv_freq=None):
    """Sinusoidal embeddings of (...,) positions (reference ``transformer.py:8-35``).
    The frequencies are computed in float64 and cast to the positions' dtype, as
    JAX casts them.

    :param inv_freq: :func:`frequencies` as a float64 tensor on ``pos``'s
        device, which spares the copy from the host (none may run while a CUDA
        graph is captured); ``None`` makes them here.
    """
    if inv_freq is None:
        inv_freq = torch.as_tensor(frequencies(d_model, lim), device=pos.device)
    ang = pos[..., None] * inv_freq.to(pos.dtype)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def visibility(mem_reset, mem_valid, reset, mem_len):
    """Attention visibility over the concatenated [memory, chunk] axis.

    :param mem_reset: (M, B) bool reset flags of the memory slots.
    :param mem_valid: (M, B) bool — False for not-yet-filled slots.
    :param reset: (T, B) bool chunk resets.
    :return: (T, M+T, B) bool — True where query i may attend key j.
    """
    M, B = mem_reset.shape
    T = reset.shape[0]
    device = reset.device
    cum = torch.cat([mem_reset, reset], 0).int().cumsum(0)     # inclusive

    q_pos = M + torch.arange(T, device=device)
    k_pos = torch.arange(M + T, device=device)
    causal = k_pos[None, :] <= q_pos[:, None]                    # (T, M+T)
    window = k_pos[None, :] > q_pos[:, None] - mem_len

    same_episode = cum[q_pos][:, None] == cum[k_pos][None]      # (T, M+T, B)
    valid = torch.cat([mem_valid, torch.ones((T, B), dtype=torch.bool, device=device)], 0)
    return causal[..., None] & window[..., None] & same_episode & valid[None, k_pos]


class Attention(nn.Module):
    """One block of relative-position multi-head attention over [memory, chunk]
    (reference ``Weights``+``Values``, ``transformer.py:80-186``)."""

    def __init__(self, d_model, mem_len, n_head=1, d_head=None, generator=None):
        super().__init__()
        self.d_model, self.mem_len, self.n_head = d_model, mem_len, n_head
        self.d_head = d_head or d_model // n_head
        NH, DH = self.n_head, self.d_head
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.q = linear(d_model, NH * DH, bias=False, generator=generator)
        self.k = linear(d_model, NH * DH, bias=False, generator=generator)
        self.k_bias = nn.Parameter(torch.randn((NH, DH), generator=generator))
        self.r = linear(d_model, NH * DH, bias=False, generator=generator)
        self.r_bias = nn.Parameter(torch.randn((NH, DH), generator=generator))
        self.v = linear(d_model, NH * DH, bias=False, generator=generator)
        self.o = linear(NH * DH, d_model, bias=False, generator=generator)
        self.register_buffer('inv_freq', torch.as_tensor(frequencies(d_model)), persistent=False)

    def forward(self, h, reset, mem):
        """:param h: (T, B, d_model); :param mem: arrdict(m, reset, valid) with m
        (M, B, d_model); :return: (out, new_mem)."""
        NH, DH = self.n_head, self.d_head
        T, B = h.shape[:2]
        M = mem.m.shape[0]
        TM = T + M

        cat = self.LayerNorm_0(torch.cat([mem.m, h], 0))            # (TM, B, d)
        q = self.q(cat[-T:]).reshape(T, B, NH, DH)
        vis = visibility(mem.reset, mem.valid, reset, self.mem_len)  # (T, TM, B)

        # Content scores, then relative-position scores: r_all[d] embeds a key
        # that is d steps before the query.
        k = self.k(cat).reshape(TM, B, NH, DH)
        score = torch.einsum('ibnd,jbnd->ijbn', q + self.k_bias, k)
        dist = torch.arange(TM, dtype=h.dtype, device=h.device)
        r_all = self.r(positional_embedding(dist, self.d_model, inv_freq=self.inv_freq))
        r_all = r_all.reshape(TM, NH, DH)
        p = torch.einsum('ibnd,jnd->ijbn', q + self.r_bias, r_all)      # (T, dist, B, NH)
        d_idx = (M + torch.arange(T, device=h.device)[:, None]
                 - torch.arange(TM, device=h.device)[None]).clamp(0, TM - 1)
        score = score + torch.gather(p, 1, d_idx[:, :, None, None].expand(T, TM, B, NH))

        score = div(score, DH**.5)
        score = torch.where(vis[..., None], score, -65000.)
        prob = torch.softmax(score, 1)
        # Zero rows where nothing was visible (start-of-episode with no memory).
        prob = torch.where(vis.any(1)[:, None, :, None], prob, 0.)

        v = self.v(cat).reshape(TM, B, NH, DH)
        summary = torch.einsum('ijbn,jbnd->ibnd', prob, v).reshape(T, B, NH * DH)
        out = F.relu(self.o(summary))

        ones = torch.ones((T, B), dtype=torch.bool, device=h.device)
        new_mem = arrdict(
            m=torch.cat([mem.m, h], 0)[-self.mem_len:].detach(),
            reset=torch.cat([mem.reset, reset], 0)[-self.mem_len:],
            valid=torch.cat([mem.valid, ones], 0)[-self.mem_len:])
        return out, new_mem


class Gate(nn.Module):
    """GRU-type gating of a residual branch (GTrXL; reference
    ``transformer.py:188-205``). ``bias`` > 0 starts the gate mostly-closed so early
    training behaves like the identity."""

    def __init__(self, d_model, bias=2., generator=None):
        super().__init__()
        self.W = linear(d_model, 3 * d_model, bias=False, generator=generator)
        self.U = linear(d_model, 2 * d_model, bias=False, generator=generator)
        self.Ug = linear(d_model, d_model, bias=False, generator=generator)
        self.b = nn.Parameter(torch.full((d_model,), float(bias)))

    def forward(self, x, y):
        wr, wz, wg = self.W(y).chunk(3, -1)
        ur, uz = self.U(x).chunk(2, -1)
        r = torch.sigmoid(wr + ur)
        z = torch.sigmoid(wz + uz - self.b)
        hh = torch.tanh(wg + self.Ug(r * x))
        return (1 - z) * x + z * hh


class GatedAttention(nn.Module):
    """Attention + feedforward, each gated (reference ``transformer.py:207-222``)."""

    def __init__(self, d_model, mem_len, n_head=1, d_head=None, generator=None):
        super().__init__()
        self.attn = Attention(d_model, mem_len, n_head, d_head, generator=generator)
        self.attn_gate = Gate(d_model, generator=generator)
        self.ff_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = linear(d_model, d_model, generator=generator)
        self.ff_gate = Gate(d_model, generator=generator)

    def forward(self, h, reset, mem):
        a, new_mem = self.attn(h, reset, mem)
        h = self.attn_gate(h, a)
        ff = F.relu(self.ff(self.ff_norm(h)))
        return self.ff_gate(h, ff), new_mem


class Transformer(nn.Module):
    """A stack of gated memory-attention layers (reference
    ``transformer.py:224-237``). Call signature matches :class:`~.lstm.LSTM`:
    ``(x, reset, state) -> (y, new_state)``."""

    def __init__(self, d_model, mem_len=32, n_layers=1, n_head=1, d_head=None,
                 generator=None):
        super().__init__()
        self.d_model, self.mem_len, self.n_layers = d_model, mem_len, n_layers
        for i in range(n_layers):
            self.add_module(f'layer{i}', GatedAttention(d_model, mem_len, n_head,
                                                        d_head, generator))

    def initial_state(self, batch, device=None, dtype=torch.float32):
        """Zeroed memory, every leaf batch-first: (B, mem_len, ...), the layout
        the learner slices minibatches of envs from."""
        def one():
            return arrdict(
                m=torch.zeros((batch, self.mem_len, self.d_model), dtype=dtype, device=device),
                reset=torch.zeros((batch, self.mem_len), dtype=torch.bool, device=device),
                valid=torch.zeros((batch, self.mem_len), dtype=torch.bool, device=device))
        return arrdict({f'layer{i}': one() for i in range(self.n_layers)})

    def forward(self, x, reset, state):
        new_state = arrdict()
        for i in range(self.n_layers):
            s = state[f'layer{i}']
            mem = arrdict(m=s.m.transpose(0, 1), reset=s.reset.T, valid=s.valid.T)
            x, new_mem = getattr(self, f'layer{i}')(x, reset, mem)
            new_state[f'layer{i}'] = arrdict(
                m=new_mem.m.transpose(0, 1), reset=new_mem.reset.T, valid=new_mem.valid.T)
        return x, new_state
