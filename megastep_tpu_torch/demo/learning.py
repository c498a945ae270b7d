"""RL math: TD deltas, discounted returns, GAE, and V-trace.

Counterpart of :mod:`megastep_tpu.demo.learning` (the reference
``megastep/demo/learning.py:5-91``), with the same reset convention: ``reset[t]``
means state ``t`` began a new episode, so no value flows across ``t-1 → t``. The
JAX package's reverse ``lax.scan``s are reverse Python loops over the time axis
here (T is the rollout buffer, 32 at the flagship config), and its
``stop_gradient``s are ``detach()``.

``v_trace_ref`` is the naive O(T²) numpy oracle the tests hold :func:`v_trace`
against.
"""
import numpy as np
import torch


def batch_indices(n_envs, batch_size, T, generator):
    """Random partition of env indices into learner minibatches of
    ``batch_size // T`` envs each (reference ``learning.py:5-10``), drawn from
    ``generator``, on its device."""
    batch_width = max(batch_size // T, 1)
    indices = torch.randperm(n_envs, generator=generator, device=generator.device)
    return [indices[i:i + batch_width] for i in range(0, n_envs, batch_width)]


def gather(arr, indices):
    """Gathers along the final axis, treewise (reference ``learning.py:12-15``)."""
    if isinstance(arr, dict):
        return type(arr)({k: gather(arr[k], indices[k]) for k in arr})
    return torch.gather(arr, -1, indices.long()[..., None])[..., 0]


def flatten(arr):
    """Concatenates tree leaves along the final axis (reference ``learning.py:17-20``)."""
    if isinstance(arr, dict):
        return torch.cat([flatten(v) for v in arr.values()], -1)
    return arr


def deltas(value, reward, target, reset, gamma=.99):
    """One-step TD errors ``r + γ·target' − value`` with resets cutting the bootstrap
    (reference ``learning.py:26-29``)."""
    reward, reset = reward[1:], reset[1:]
    regular = (reward + gamma * target[1:]) - value[:-1]
    return torch.where(reset, reward - value[:-1], regular)


def present_value(dv, finals, reset, alpha):
    """Reverse discounted accumulation: ``acc[t] = dv[t] + α·(1−reset[t])·acc[t+1]``
    seeded with ``finals`` (reference ``learning.py:31-40``)."""
    acc, out = finals, []
    for t in reversed(range(dv.shape[0])):
        acc = dv[t] + acc * alpha * (1 - reset[t].to(dv.dtype))
        out.append(acc)
    return torch.stack(out[::-1])


def generalized_advantages(value, reward, v, reset, gamma, lambd=.97):
    """GAE(γ, λ) with terminal advantage zero (reference ``learning.py:42-47``)."""
    dv = deltas(value, reward, v, reset, gamma=gamma)
    finals = torch.zeros_like(dv[-1])
    adv = torch.cat([present_value(dv, finals, reset[1:], lambd * gamma), finals[None]], 0)
    return adv.detach()


def reward_to_go(reward, value, reset, gamma):
    """Discounted returns bootstrapped from the final value
    (reference ``learning.py:49-50``)."""
    out = torch.cat([present_value(reward[1:], value[-1], reset[1:], gamma), value[-1:]], 0)
    return out.detach()


def v_trace(ratios, value, reward, reset, gamma, max_rho=1, max_c=1):
    """V-trace value targets with clipped importance weights ρ and c
    (IMPALA; reference ``learning.py:52-69``)."""
    rho = ratios.clamp(0, max_rho)
    c = ratios.clamp(0, max_c)
    dV = rho[:-1] * deltas(value, reward, value, reset, gamma=gamma)

    discount = (1 - reset[1:].to(value.dtype)) * gamma
    A = value[:-1] + dV - discount * c[:-1] * value[1:]
    B = discount * c[:-1]

    v_next, head = value[-1], []
    for t in reversed(range(A.shape[0])):
        v_next = A[t] + B[t] * v_next
        head.append(v_next)
    return torch.cat([torch.stack(head[::-1]), value[-1:]], 0).detach()


def v_trace_ref(ratios, value, reward, reset, gamma=.99, max_rho=1, max_c=1):
    """Naive O(T²) numpy V-trace oracle for testing (reference
    ``learning.py:75-91``). Takes tensors or arrays."""
    ratios, value, reward, reset = (
        x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        for x in (ratios, value, reward, reset))
    rho = ratios.clip(0, max_rho)
    c = ratios.clip(0, max_c)

    v = value.copy().astype(float)
    for s in range(len(v) - 1):
        for t in range(s, len(v) - 1):
            prod_c = c[s:t].prod()
            if reset[t + 1]:
                dV = rho[t] * (reward[t + 1] - value[t])
                v[s] += gamma**(t - s) * prod_c * dV
                break
            else:
                dV = rho[t] * (reward[t + 1] + gamma * value[t + 1] - value[t])
                v[s] += gamma**(t - s) * prod_c * dV
    return v
