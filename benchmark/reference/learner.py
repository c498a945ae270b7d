"""The plain reference of the demo train step: the rollout under the policy,
then PPO-clip with V-trace value targets over minibatches of env columns, a
global-norm clip and AMSGrad, and the KL early stop.

Written from the reference megastep's trainer (``megastep/demo/__init__.py:37-148``,
``megastep/demo/learning.py``) with optax's AMSGrad (the maximum kept of the
bias-corrected second moment, eps 1e-8, no eps inside the root) behind
``clip_by_global_norm(100)``. Imports nothing of the program.
"""
import torch

B1, B2, EPS = .9, .999, 1e-8


def _deltas(value, reward, target, reset, gamma):
    reward, reset = reward[1:], reset[1:]
    return torch.where(reset, reward - value[:-1], (reward + gamma * target[1:]) - value[:-1])


def advantages(value, reward, reset, gamma, lambd=.97):
    """GAE(gamma, lambda), the last step's advantage zero."""
    dv = _deltas(value, reward, value, reset, gamma)
    acc, out = torch.zeros_like(dv[-1]), []
    for t in reversed(range(dv.shape[0])):
        acc = dv[t] + acc * (lambd * gamma) * (1 - reset[1:][t].to(dv.dtype))
        out.append(acc)
    return torch.cat([torch.stack(out[::-1]), torch.zeros_like(dv[-1])[None]], 0).detach()


def v_trace(ratios, value, reward, reset, gamma):
    """V-trace targets with rho and c clipped at 1."""
    rho, c = ratios.clamp(0, 1), ratios.clamp(0, 1)
    dV = rho[:-1] * _deltas(value, reward, value, reset, gamma)
    discount = (1 - reset[1:].to(value.dtype)) * gamma
    A = value[:-1] + dV - discount * c[:-1] * value[1:]
    B = discount * c[:-1]
    v, head = value[-1], []
    for t in reversed(range(A.shape[0])):
        v = A[t] + B[t] * v
        head.append(v)
    return torch.cat([torch.stack(head[::-1]), value[-1:]], 0).detach()


def ppo_loss(agent, batch, state0, entropy=1e-2, gamma=.99, clip=.2, half=False):
    """The minibatch loss and its terms. ``half`` is a planted fault, for the
    benchmark's own test of its check: the means over the first half of the
    minibatch's envs only."""
    logits, value, _, _ = agent(batch['obs'], batch['reset'], state0)
    old = torch.gather(batch['logits'], -1, batch['actions'].long()[..., None])[..., 0].sum(-1)
    new = torch.gather(logits, -1, batch['actions'].long()[..., None])[..., 0].sum(-1)
    ratio = torch.exp(new - old).clamp(.05, 20)
    reward, reset, v0 = batch['reward'], batch['reset'], batch['value']
    v_target = v_trace(ratio, value, reward, reset, gamma)
    v_clipped = v0 + (value - v0).clamp(-10, +10)
    v_err = torch.maximum((value - v_target)**2, (v_clipped - v_target)**2)
    adv = advantages(value, reward, reset, gamma)
    keep = slice(None, adv.shape[1] // 2 if half else None)
    normed = (adv - adv[:, keep].mean()) / (1e-3 + adv[:, keep].std(correction=0))
    p_err = torch.minimum(ratio * normed, ratio.clamp(1 - clip, 1 + clip) * normed)
    h = (torch.exp(logits) * logits).sum(-1)
    v_loss = .5 * v_err[:, keep].mean()
    p_loss = -p_err[:, keep].mean()
    h_loss = h[:, keep].mean()
    kl = -(new - old)[:, keep].mean()
    return v_loss + p_loss + entropy * h_loss, kl


class AMSGrad:
    """``clip_by_global_norm(max_norm)`` then optax's AMSGrad."""

    def __init__(self, params, lr, max_norm=100.):
        self.params, self.lr, self.max_norm, self.count = list(params), lr, max_norm, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.max_norm
        grads = [torch.where(keep, g, g / norm * self.max_norm) for g in grads]
        self.count += 1
        full = lambda x: torch.full((), x, dtype=torch.float32, device=self.params[0].device)
        c1, c2 = 1 - full(B1)**self.count, 1 - full(B2)**self.count
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * g**2 + B2 * nu)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            p.add_(mu / c1 / (torch.sqrt(nu_max) + EPS) * -self.lr)
            p.grad = None
        return grads


@torch.no_grad()
def rollout(agent, env_step, obs, reset, reward, env_state, agent_state, uniforms, T):
    """``T`` steps: the agent's forward at T=1 on the last world, an action
    from ``uniforms()``, then ``env_step``. Returns the chunk of (T, B, ...)
    leaves and the carry after it."""
    keys = ('obs', 'reset', 'reward', 'logits', 'value', 'actions')
    chunk = {k: [] for k in keys}
    for _ in range(T):
        o = {k: v[None] for k, v in obs.items()}
        B = reset.shape[0]
        u = uniforms((1, B) + agent.shape)
        logits, value, actions, agent_state = agent(o, reset[None], agent_state, u)
        for k, v in zip(keys, (obs, reset, reward, logits[0], value[0], actions[0])):
            chunk[k].append(v)
        env_state, world = env_step(env_state, actions[0])
        obs, reset, reward = world['obs'], world['reset'], world['reward']
    chunk = {k: (torch.stack(v) if k != 'obs' else
                 {o: torch.stack([x[o] for x in v]) for o in v[0]}) for k, v in chunk.items()}
    return chunk, (obs, reset, reward, env_state, agent_state)


def learn(agent, opt, chunk, state0, batches, kl_limit=.02, half=False, on_update=None):
    """Minibatched PPO with the KL stop. ``on_update(grads)`` is called after
    each update with the clipped gradients the optimizer took.

    :return: the minibatches' losses, as floats.
    """
    losses = []
    for idx in batches:
        batch = {k: ({o: x[:, idx] for o, x in v.items()} if k == 'obs' else v[:, idx])
                 for k, v in chunk.items()}
        s0 = {k: tuple(x[idx] for x in v) for k, v in state0.items()}
        loss, kl = ppo_loss(agent, batch, s0, half=half)
        loss.backward()
        grads = opt.step()
        if on_update is not None:
            on_update(grads)
        losses.append(float(loss.detach()))
        if float(kl.detach()) > kl_limit:
            break
    return losses
