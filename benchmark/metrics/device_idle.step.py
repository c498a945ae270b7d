"""The device's idle share over the traced env steps: one
minus the union of the device operations' intervals over their wall
span, both from one ``torch.profiler`` trace. In percent."""
from benchmark import common


def read(rec):
    trace = rec.get('trace')
    return None if trace is None else 100 * (1 - common.busy_share(trace))
