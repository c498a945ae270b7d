"""The plain reference of the demo agent: intakes, a reset-aware LSTM core,
the policy and value heads, and the Gumbel-max action draw.

Written from the reference megastep's agent (``megastep/demo/__init__.py:13-35``,
``megastep/demo/heads.py``, ``megastep/demo/lstm.py``) with flax's initial
distributions, as the configuration states them: ``lecun_normal`` (a normal
truncated at two standard deviations, scaled by fan-in) for every dense and conv
kernel, zero biases, an orthogonal (H, H) block per gate of the LSTM's recurrent
kernel. Parameters are drawn from one CPU ``torch.Generator`` in construction
order, so the seed fixes them. Dict spaces are taken in sorted key order (d, imu,
rgb). Imports nothing of the program.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

CONVS = ((32, 8, 4), (64, 4, 2), (128, 3, 2))
TRUNCATED_STD = .87962566103423978


@torch.no_grad()
def _lecun(weight, fan_in, generator):
    nn.init.trunc_normal_(weight, 0., 1., -2., 2., generator=generator)
    weight.mul_(math.sqrt(1 / fan_in) / TRUNCATED_STD)


def _linear(d_in, d_out, generator, bias=True):
    layer = nn.Linear(d_in, d_out, bias=bias)
    _lecun(layer.weight, d_in, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class ImageIntake(nn.Module):
    """(A, C, 1, W) images: three (1, k) convs (kernels 8/4/3, strides 4/2/2),
    flattened channels-last, then two dense layers; ReLU after each."""

    def __init__(self, shape, width, generator):
        super().__init__()
        A, C, H, W = shape
        for i, (c_out, k, s) in enumerate(CONVS):
            conv = nn.Conv2d(C, c_out, (1, k), stride=(1, s))
            _lecun(conv.weight, C * k, generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f'Conv_{i}', conv)
            C, W = c_out, (W - k) // s + 1
        self.Dense_0 = _linear(A * H * W * C, width, generator)
        self.Dense_1 = _linear(width, width, generator)
        self.shape = shape

    def forward(self, obs):
        A, C, H, W = self.shape
        lead = obs.shape[:-4]
        x = obs.reshape(-1, C, H, W)
        for i in range(len(CONVS)):
            x = F.relu(getattr(self, f'Conv_{i}')(x))
        x = F.relu(self.Dense_0(x.permute(0, 2, 3, 1).reshape(*lead, -1)))
        return F.relu(self.Dense_1(x))


class VectorIntake(nn.Module):
    """(A, C) vectors: a dense layer per agent, then one over all agents."""

    def __init__(self, shape, width, generator):
        super().__init__()
        A, C = shape
        self.Dense_0 = _linear(C, width, generator)
        self.Dense_1 = _linear(A * width, width, generator)

    def forward(self, obs):
        x = F.relu(self.Dense_0(obs))
        return F.relu(self.Dense_1(x.reshape(*obs.shape[:-2], -1)))


class Intake(nn.Module):
    """Each key's intake, concatenated in sorted key order, then a dense mix."""

    def __init__(self, shapes, width, generator):
        super().__init__()
        self.keys = sorted(shapes)
        for k in self.keys:
            cls = ImageIntake if len(shapes[k]) == 4 else VectorIntake
            self.add_module(k, cls(shapes[k], width, generator))
        self.Dense_0 = _linear(len(shapes) * width, width, generator)

    def forward(self, obs):
        return self.Dense_0(torch.cat([getattr(self, k)(obs[k]) for k in self.keys], -1))


class LSTM(nn.Module):
    """Gates (i, f, g, o); the carried (h, c) zeroed before step ``t`` where
    ``reset[t]``; the bias on the recurrent projection only."""

    def __init__(self, width, generator):
        super().__init__()
        self.width = width
        self.wi = _linear(width, 4 * width, generator, bias=False)
        self.wh = _linear(width, 4 * width, generator)
        with torch.no_grad():
            for block in self.wh.weight.chunk(4, 0):
                nn.init.orthogonal_(block, generator=generator)

    def forward(self, x, reset, h, c):
        xw = self.wi(x)
        ys = []
        for t in range(x.shape[0]):
            keep = ~reset[t][:, None]
            c = torch.where(keep, c, 0.)
            h = torch.where(keep, h, 0.)
            z = self.wh(h) + xw[t]
            zi, zf, zg, zo = z.chunk(4, -1)
            c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h = torch.sigmoid(zo) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys), h.detach(), c.detach()


class Agent(nn.Module):
    """Policy: intake, LSTM, dense to log-softmax over ``n_actions`` per agent.
    Value: its own intake and LSTM, dense to a scalar."""

    def __init__(self, obs_shapes, n_agents, n_actions, width, generator):
        super().__init__()
        self.width, self.shape = width, (n_agents, n_actions)
        self.policy_intake = Intake(obs_shapes, width, generator)
        self.policy_core = LSTM(width, generator)
        self.policy_out = _linear(width, n_agents * n_actions, generator)
        self.value_intake = Intake(obs_shapes, width, generator)
        self.value_core = LSTM(width, generator)
        self.value_out = _linear(width, 1, generator)

    def initial_state(self, batch, device):
        z = lambda: torch.zeros((batch, self.width), device=device)
        return dict(policy=(z(), z()), value=(z(), z()))

    def forward(self, obs, reset, state, uniforms=None):
        """Over a (T, B, ...) chunk. With ``uniforms`` (shaped like the logits),
        the actions drawn from them by the Gumbel-max trick.

        :return: ``(logits, value, actions or None, new_state)``.
        """
        py, ph, pc = self.policy_core(self.policy_intake(obs), reset, *state['policy'])
        y = self.policy_out(py)
        logits = F.log_softmax(y.reshape(*y.shape[:-1], *self.shape), -1)
        vy, vh, vc = self.value_core(self.value_intake(obs), reset, *state['value'])
        value = self.value_out(vy)[..., 0]
        actions = None
        if uniforms is not None:
            u = uniforms.clamp(min=torch.finfo(logits.dtype).tiny)
            actions = torch.argmax(logits - torch.log(-torch.log(u)), -1)
        return logits, value, actions, dict(policy=(ph, pc), value=(vh, vc))
