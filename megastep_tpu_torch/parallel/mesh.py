"""Env-axis data parallelism over ``torch.distributed`` ranks.

Counterpart of :mod:`megastep_tpu.parallel.mesh`. The layout is the JAX
module's: the env batch is split over the ranks, and every rank holds the whole
agent and optimizer state. The way it runs is not. The JAX package is one SPMD
program over a device mesh, where GSPMD inserts the collectives and every
reduction keeps its global meaning. Here each rank is a process of its own (the
original megastep's way, with DDP): it builds and steps only its slice of the
envs (:mod:`.host`), and every collective is explicit. The sharded train step
(:func:`megastep_tpu_torch.demo.train.make_train_step` with ``mesh=``) issues
these, all over the mesh's group, and nothing else:

  * per minibatch that runs: two value all-reduces for the advantage
    statistics (the global mean, then the global mean squared deviation); one
    all-reduce of all the gradients as one flat buffer, divided by the world
    before the optimizer clips by the global norm; and one all-reduce of the
    loss terms, so that the KL stop reads the global ``kl_div`` and every rank
    stops on the same minibatch;
  * per chunk: one all-reduce of ``as_chunk``'s sums.

:attr:`Mesh.counts` counts them by kind, and :func:`chunk_collectives` is the
list that a chunk must issue.

The JAX module's other functions describe how XLA places one global array,
and a process-per-rank port has no global array, so they have no counterpart:

  * ``env_sharding`` and ``replicated`` (``NamedSharding``s of the env axis
    and of a replicated leaf), ``shard_carry`` and ``shard_env`` (their trees
    over the carry and the env) and ``place_env`` (the env's ``device_put``):
    each rank builds its env slice on its own device, and nothing is placed;
  * ``place_carry``: :func:`init_sharded` broadcasts the parameters and the
    optimizer state from rank 0 instead, and checks that every rank then holds
    the same bytes;
  * ``resharding_collectives``, the HLO guard that only the gradient
    all-reduce runs: :attr:`Mesh.counts` takes its place;
  * ``host.assemble_env``, which makes global arrays of the hosts' slices.
"""
import collections
import dataclasses
import hashlib

import torch
import torch.distributed as dist

from ..ops.geom import div
from ..scene import resolve_device

ENV_AXIS = 'env'


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the ranks: its ``rank`` of ``world``, the
    ``device`` it steps its envs and agent on, and the process ``group``
    (``None``: the default group). Every collective of the sharded step goes
    through :meth:`all_reduce` or :meth:`broadcast`, which count it in
    ``counts`` by kind."""
    rank: int
    world: int
    device: torch.device
    group: object = None
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False, repr=False)

    def all_reduce(self, tensor, op=dist.ReduceOp.SUM):
        """Reduces ``tensor`` over the ranks, in place, and returns it."""
        self.counts['all_reduce'] += 1
        dist.all_reduce(tensor, op=op, group=self.group)
        return tensor

    def broadcast(self, tensor, src=0):
        """Overwrites ``tensor`` with rank ``src``'s, in place, and returns it."""
        self.counts['broadcast'] += 1
        dist.broadcast(tensor, src, group=self.group)
        return tensor

    def mean(self, tensor):
        """The mean over the ranks of ``tensor``: one all-reduce, then a true
        division by the world (exact at a world of one)."""
        return div(self.all_reduce(tensor), self.world)

    def moments(self, x):
        """The mean and the standard deviation (ddof 0) of ``x`` over every
        rank's block, each block the same size, as ``jnp.std`` computes them
        over the global array: the global mean, then the global mean squared
        deviation from it, two all-reduces. A rank's mean squared deviation
        from the global mean is its own variance plus its mean's squared
        offset, which at a world of one is exactly ``x.std(correction=0)``."""
        mean = self.mean(x.mean())
        return mean, self.mean(x.var(correction=0) + (x.mean() - mean)**2).sqrt()


def mesh(device='cuda', group=None):
    """This process's :class:`Mesh` in ``group`` (``None``: the default group,
    which :func:`megastep_tpu_torch.rebar.processes.initialize` sets up).

    :param device: the device of this rank's envs and agent; ``'cuda'`` unless
        the caller says so. Under NCCL each rank needs a GPU of its own
        (``f'cuda:{rank}'``); ranks that share a GPU, or run on the CPU, use
        gloo.
    """
    if not dist.is_initialized():
        raise RuntimeError('no process group: call rebar.processes.initialize first')
    return Mesh(dist.get_rank(group), dist.get_world_size(group), resolve_device(device),
                group)


def chunk_collectives(minibatches):
    """The collectives one chunk of the sharded step issues, by kind, when
    ``minibatches`` of its minibatches ran."""
    return collections.Counter(all_reduce=4 * minibatches + 1)


def digest(tensors):
    """A SHA-256 of the tensors' bytes, in order: equal digests on two ranks
    mean bit-equal tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def replicate(agent, opt, m):
    """Broadcasts the agent's parameters and the optimizer's state from rank 0
    as one flat buffer, then checks that every rank holds the same bytes (an
    all-reduce of their bits by MAX and by MIN)."""
    tensors = [*agent.state_dict().values(), *opt.mu, *opt.nu, *opt.nu_max]
    count = torch.full((1,), opt.count, dtype=torch.float32, device=m.device)
    flat = m.broadcast(torch.cat([*(t.reshape(-1) for t in tensors), count]))
    for t, v in zip(tensors, flat[:-1].split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))
    opt.count = int(flat[-1])
    bits = flat.view(torch.int32)
    hi = m.all_reduce(bits.clone(), dist.ReduceOp.MAX)
    lo = m.all_reduce(bits.clone(), dist.ReduceOp.MIN)
    if not torch.equal(hi, lo):
        raise RuntimeError('the ranks hold different parameters after the broadcast')


def make_sharded_train_step(env, m, **kwargs):
    """The one-chunk training step over mesh ``m``: ``env`` is this rank's
    slice, and ``kwargs`` (``buffer_size``, the global ``batch_size``, ...)
    reach :func:`megastep_tpu_torch.demo.train.make_train_step`.

    :return: ``step(carry, generator, mark=None) -> (carry, metrics)``, as the
        single-device step; ``generator`` is this rank's own, and the metrics
        are global.
    """
    from ..demo.train import make_train_step
    return make_train_step(env, mesh=m, **kwargs)


def init_sharded(env, agent, opt, generator, m, **kwargs):
    """A carry for this rank (its env slice reset from its ``generator``), the
    parameters and optimizer state replicated from rank 0
    (:func:`replicate`), and the sharded step. ``kwargs`` reach
    :func:`make_sharded_train_step`.

    :return: ``(carry, step)``, ready to run as ``step(carry, generator)``.
    """
    from ..demo.train import init_carry
    carry = init_carry(env, agent, opt, generator)
    replicate(agent, opt, m)
    return carry, make_sharded_train_step(env, m, **kwargs)
