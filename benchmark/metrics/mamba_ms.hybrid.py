"""Device ms of the Mamba-2 mixers in a chunk's rollout: the device time of
the operations launched inside the program's ``core.mamba`` spans in the
traced run's spans chunk (``benchmark/spans.py``'s pass B). The learner's
mixers run inside its CUDA graph's replay, which records no spans, so every
``core.mamba`` of the chunk is a rollout step's."""


def read(rec):
    row = (rec.get('spans') or {}).get('core.mamba')
    return None if row is None else float(row['device_ms'])
