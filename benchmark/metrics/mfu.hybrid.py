"""The whole hybrid train step's share of the card's f32 peak (67 TFLOP/s,
TF32 off): the agent's FLOPs for the samples the window ran (a forward for
each rollout sample; a forward and its backward for each sample of each
learner minibatch that ran), from the frozen count ``counts/hybrid.py``, over
the window's seconds. In percent."""
from benchmark import common
from benchmark.counts import hybrid, work


def read(rec):
    if not rec.get('chunks') or 'hybrid' not in rec:
        return None
    forward, first = hybrid.agent(rec['obs_shapes'], rec['n_actions'], rec['hybrid'])
    learned = sum(rec['minibatches']) * rec['batch']
    flops = (rec['chunks'] * rec['samples_per_chunk'] * forward
             + learned * work.train_sample(forward, first))
    return 100 * flops / (rec['window_s'] * common.F32_FLOPS)
