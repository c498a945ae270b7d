"""The f32 noise in the flagship train step's gradients, on the card and the CPU.

One optimizer step of the flagship agent (Explorer, 256-wide LSTM) on a (T, B)
minibatch of its own rollout gives gradients that the card and the CPU compute
in f32 with sums in different orders. This measures how far apart those fall
when nothing but the order differs: the same minibatch with its env columns
reversed (the loss is a mean over the columns, so the reversal changes only
the order of the sums), on the CPU and on the card, beside the card against
the CPU, and each against the CPU's float64 step on the same minibatch.
``chip_smoke.py``'s train phase holds the card against the CPU with
:func:`step_results` and :func:`reversed_columns`. Usage (on the card)::

    python -m megastep_tpu_torch.perf.grad_noise --states 4

It prints, for each trained state (one chunk apart), the largest gradient and
the largest differences between the four computations, and the gradient
element where the card and the CPU differ most.
"""
import argparse
import copy
import json

import torch

from ..demo.train import optimize, optimizer, rollout
from . import train_flagship


def _f64(x):
    """A tensor of the minibatch in float64: floats cast, uint8 images scaled
    to [0, 1] as the intake scales them; others as they are."""
    if x.dtype == torch.uint8:
        return x.double() / 255
    return x.double() if x.is_floating_point() else x


def step_results(agent, opt, batch, state0, device, f64=False, forward=True):
    """One :func:`~megastep_tpu_torch.demo.train.optimize` step of copies of
    ``agent`` and ``opt`` on ``device``, from ``opt``'s state, in float64 if
    ``f64``. Returns the loss, the gradients and the parameters after the
    step, and with ``forward`` the logits and value of a forward before it,
    all on the CPU."""
    cast = _f64 if f64 else (lambda x: x)
    a = copy.deepcopy(agent).to(device)
    if f64:
        a.double()
    b, s0 = (batch.map(lambda x: cast(x.to(device))),
             state0.map(lambda x: cast(x.to(device))))
    o = optimizer(a.parameters(), opt.lr)
    o.count = opt.count
    for k in ('mu', 'nu', 'nu_max'):
        setattr(o, k, [cast(x.detach().to(device).clone()) for x in getattr(opt, k)])
    out = {}
    if forward:
        with torch.no_grad():
            d, _ = a(b.world, s0, value=True)
        out.update(logits=d.logits.cpu(), value=d.value.cpu())
    aux = optimize(a, o, b, s0)
    return dict(out, loss=aux['loss'].cpu(), grads=[p.grad.cpu() for p in a.parameters()],
                params=[p.detach().cpu() for p in a.parameters()])


def reversed_columns(batch, state0):
    """The minibatch (T, B, ...) and its start state (B, ...) with the env
    columns in reverse order."""
    return batch.map(lambda x: x.flip(1)), state0.map(lambda x: x.flip(0))


def max_diff(xs, ys):
    """The largest absolute difference between two lists of tensors."""
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


def measure(run, n_cols, T=32, card='cuda'):
    """The four gradient computations on a (``T``, ``n_cols``) minibatch of a
    fresh rollout of ``run`` (from :func:`train_flagship.build`), the card's
    on the device ``card``."""
    carry = run.carry
    state0 = carry.agent_state.map(lambda x: x[:n_cols])
    _, _, _, chunk = rollout(run.env, run.agent, carry.env_state, carry.world,
                             carry.agent_state, run.generator, T)
    batch = chunk.map(lambda x: x[:, :n_cols].contiguous())
    flipped = reversed_columns(batch, state0)
    grads = {}
    for name, device, (b, s0) in (('card', card, (batch, state0)),
                                  ('card_reversed', card, flipped),
                                  ('cpu', 'cpu', (batch, state0)),
                                  ('cpu_reversed', 'cpu', flipped)):
        grads[name] = step_results(run.agent, run.opt, b, s0, device, forward=False)['grads']
    exact = step_results(run.agent, run.opt, batch, state0, 'cpu', f64=True,
                         forward=False)['grads']
    names = [n for n, _ in run.agent.named_parameters()]
    card, cpu = grads['card'], grads['cpu']
    i = max(range(len(card)), key=lambda j: float((card[j] - cpu[j]).abs().max()))
    k = int((card[i] - cpu[i]).abs().argmax())
    return {'grad_scale': max(float(g.abs().max()) for g in cpu),
            'card_vs_cpu': max_diff(card, cpu),
            'cpu_vs_cpu_reversed': max_diff(cpu, grads['cpu_reversed']),
            'card_vs_card_reversed': max_diff(card, grads['card_reversed']),
            'card_reversed_vs_cpu_reversed': max_diff(grads['card_reversed'],
                                                      grads['cpu_reversed']),
            'card_vs_f64': max_diff(card, exact), 'cpu_vs_f64': max_diff(cpu, exact),
            'worst': {'param': names[i], 'card': float(card[i].flatten()[k]),
                      'cpu': float(cpu[i].flatten()[k]),
                      'cpu_reversed': float(grads['cpu_reversed'][i].flatten()[k]),
                      'f64': float(exact[i].flatten()[k]),
                      'param_grad_scale': float(cpu[i].abs().max())}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--states', type=int, default=4, help='trained states, a chunk apart')
    p.add_argument('--cols', type=int, default=512, help='env columns of the minibatch')
    p.add_argument('--envs', type=int, default=8 * 1024)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('grad_noise: no CUDA device')
    torch.set_num_threads(min(torch.get_num_threads(), 8))
    run = train_flagship.build('explorer', args.envs, res=256, subsample=4)
    for s in range(args.states):
        train_flagship.timed_chunks(run, 1)
        print(json.dumps({'state': s + 1, **measure(run, args.cols)}), flush=True)


if __name__ == '__main__':
    main()
