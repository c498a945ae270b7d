"""The device's idle share during a traced chunk of the train step: one
minus the union of the device operations' intervals over the chunk's wall
span, both from one ``torch.profiler`` trace. In percent."""
from benchmark import common


def read(rec):
    trace = rec.get('trace')
    return None if trace is None else 100 * (1 - common.busy_share(trace))
