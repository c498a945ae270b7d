"""The benchmark's frozen counts of work: what one observe launch, one
Deathmatch re-bake and one sample through the agent need, computed from
shapes, the same for every implementation.

The observe count is the port's roofline arithmetic
(``megastep_tpu_torch/perf/roofline.py::observe_counts``) frozen here, with the
plain algorithm's work in every mode: one ray-line test per (agent, ray, live
line slot) of 18 f32 operations, its two divides among them; each input byte
read once and each output byte written once. The agent's count is the matrix
and convolution work, two operations a multiply-add, as
``torch.utils.flop_counter`` counts it (``benchmark/tests/test_bench_counts.py``
holds both to the port and to the counter).
"""
OPS_PER_TEST = 18
CONVS = ((32, 8, 4), (64, 4, 2), (128, 3, 2))


def observe(n, agents, rays, live, hits, t_dyn=0, seen=None):
    """One observe launch over ``n`` envs of ``agents`` agents and ``rays``
    rays: ``live`` line slots tested in all (summed over envs), ``hits`` rays
    that hit a line, ``t_dyn`` re-lit texels an env, ``seen`` the seen mask's
    elements (None when the launch makes none).

    :return: ``(bytes, f32 operations)``.
    """
    nbytes = (live * 24            # live line slots: endpoints, texel start, width
              + n * agents * 12    # pose: angle, x, y
              + n * t_dyn * 4      # this frame's model-texel light
              + hits * 32          # two 16-byte texel taps per hit ray
              + n * agents * rays * 20)  # index, distance, rgb per ray
    if seen is not None:
        nbytes += seen + hits      # the mask's zero fill, a byte per hit
    return nbytes, agents * rays * live * OPS_PER_TEST


def rebake(texels, lights, walls):
    """f32 operations of the Deathmatch re-bake: one occlusion test of 18
    operations per (model texel, light, live wall), all summed over scenes."""
    return texels * lights * walls * OPS_PER_TEST


def roofline_ms(nbytes, ops, bytes_per_s=3.35e12, ops_per_s=67e12):
    """The least time one H100 could take: the larger of the bytes over the
    memory rate and the operations over the f32 rate, in ms."""
    return 1e3 * max(nbytes / bytes_per_s, ops / ops_per_s)


def agent(obs_shapes, n_actions, width):
    """FLOPs of one sample through the agent's forward (policy and value),
    and of the layers that take the observations, whose input needs no
    gradient.

    :param obs_shapes: per key, ``(A, C, H, W)`` for an image, ``(A, C)`` for
        a vector; the agent takes the keys in sorted order.
    :return: ``(forward, first_layers)``.
    """
    intake, first = 0, 0
    for k in sorted(obs_shapes):
        shape = obs_shapes[k]
        if len(shape) == 4:
            A, C, H, W = shape
            for i, (c_out, kk, s) in enumerate(CONVS):
                W = (W - kk) // s + 1
                flops = 2 * A * H * W * C * kk * c_out
                first += flops if i == 0 else 0
                intake += flops
                C = c_out
            intake += 2 * A * H * W * C * width + 2 * width * width
        else:
            A, C = shape
            first += 2 * A * C * width
            intake += 2 * A * C * width + 2 * A * width * width
    intake += 2 * len(obs_shapes) * width * width
    lstm = 2 * 2 * width * 4 * width
    A = next(iter(obs_shapes.values()))[0]
    forward = 2 * (intake + lstm) + 2 * width * A * n_actions + 2 * width
    return forward, 2 * first


def train_sample(forward, first_layers):
    """FLOPs of one sample through a learner minibatch: the forward, every
    weight's gradient, and every layer's input gradient but the first ones'."""
    return forward + forward + (forward - first_layers)
