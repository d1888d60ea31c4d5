# corpus-rules: rng
"""torch.Generator discipline: draws from the process-global stream, a
generator never seeded, seeds from the wall clock, and ``torch.seed``;
the seeded, generator-threaded shapes the port uses stay quiet."""

import time

import torch
import torch.nn.functional as F


def global_draws(x, shape):
    u = torch.rand(shape)  # expect: CST-RNG-002
    v = torch.randint(0, 10, shape)  # expect: CST-RNG-002
    x.uniform_()  # expect: CST-RNG-002
    return F.dropout(u + v, 0.1)  # expect: CST-RNG-002


def unseeded_generator(shape):
    g = torch.Generator()  # expect: CST-RNG-002
    return torch.rand(shape, generator=g)


def wallclock_seeds(shape):
    g = torch.Generator().manual_seed(time.time_ns())  # expect: CST-RNG-002
    h = torch.Generator(device="cpu")
    h.manual_seed(int(time.time()))  # expect: CST-RNG-002
    torch.seed()  # expect: CST-RNG-002
    return torch.rand(shape, generator=g) + torch.rand(shape, generator=h)


def seeded(cfg, shape, step, x):
    # negative: the port's shapes — chained or two-statement seeding
    # from the config, every draw threaded through generator=
    g = torch.Generator().manual_seed(cfg.train.seed)
    h = torch.Generator(device="cpu")
    h.manual_seed(cfg.train.seed + step)
    x.uniform_(generator=g)
    keep = F.dropout(x, 0.1, training=False)
    return torch.rand(shape, generator=g) + torch.randn(shape, generator=h) + keep
