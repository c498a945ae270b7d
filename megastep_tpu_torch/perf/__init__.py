"""Performance tooling of the port (counterpart of the JAX package's ``perf/``).

:mod:`.roofline` counts the observe kernel's work, turns it into per-unit times
at the card's published peaks, and measures attainable peaks on the card with
three probes, one of them the hand-written CUDA kernel ``csrc/vpu_probe.cu``.
"""
