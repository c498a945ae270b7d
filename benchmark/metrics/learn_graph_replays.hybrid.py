"""Replays of the learner's CUDA graph a minibatch, in the traced run's spans
chunk: the program's ``learn_graph_replays`` counter over the chunk's
minibatches. It reads 1 on the graph path, whatever the KL stop cut the chunk
to, and 0 if the learner fell back to the eager loop."""


def read(rec):
    counts, minibatches = rec.get('span_counts'), rec.get('span_minibatches')
    if counts is None or not minibatches:
        return None
    return float(counts.get('learn_graph_replays', 0)) / float(minibatches)
