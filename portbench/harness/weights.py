"""The weights of a run, drawn by the benchmark from ``--seed`` on the
device and handed alike to the program and to the plain reference.

Each entry of the model's state is drawn by the first rule of the
configuration's ``init`` whose pattern it matches, from a generator of its
own seeded by ``(seed, entry index)``: one draw an entry, so that any
entry can be drawn again alone (the check of a training cell redraws each
entry's starting value to measure how far it moved)."""

import re

import numpy as np
import torch


def entry_seed(seed, index):
    state = np.random.SeedSequence([int(seed), int(index), 7])
    return int(state.generate_state(1, np.uint64)[0] & (2 ** 63 - 1))


def draw_one(rules, name, shape, seed, index, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(entry_seed(seed, index))
    for pattern, dist, arg in rules:
        if re.search(pattern, name):
            break
    else:
        raise ValueError("no init rule matches %r" % name)
    t = torch.empty(shape, device=device)
    if dist == "normal":
        return t.normal_(0.0, float(arg), generator=gen)
    if dist == "fan_in":
        fan_in = shape[1] if len(shape) > 1 else shape[0]
        return t.normal_(0.0, float(arg) / fan_in ** 0.5, generator=gen)
    if dist == "uniform":
        return t.uniform_(float(arg[0]), float(arg[1]), generator=gen)
    if dist == "zeros":
        return t.zero_()
    raise ValueError("unknown init %r" % dist)


def draw(config, layout, seed, device):
    """``{name: tensor}`` for every entry of ``layout``
    (``program.layout``)."""
    return {name: draw_one(config["init"], name, shape, seed, i, device)
            for i, (name, shape, _) in enumerate(layout)}


def redraw(config, layout, seed, device, name):
    """Entry ``name`` drawn again, as :func:`draw` drew it."""
    for i, (n, shape, _) in enumerate(layout):
        if n == name:
            return draw_one(config["init"], n, shape, seed, i, device)
    raise KeyError(name)
