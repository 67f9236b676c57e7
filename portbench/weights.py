"""Weights made by the benchmark from the seed, on the card, in one draw.

The layout (each leaf's name and shape) is the port's, read from its
``init`` on the ``meta`` device, which allocates nothing.  The values are
the benchmark's: every leaf's rule comes from the configuration file's
``init`` table, by the leaf's last name: ``["normal", s]`` (N(0, 1) x s,
``s = "fan_in"`` meaning ``shape[0] ** -0.5``), ``["const", c]``,
``["log_linspace", a, b]`` (the log of ``linspace(a, b, shape[0])``) or
``["inv_softplus", c]`` (``log(expm1(c))``).  The normal leaves are views of
one float32 buffer filled by one ``normal_`` call of a seeded
``torch.Generator`` on the device, so the same seed gives the same weights
again, and the port and the plain reference receive the same tensors.
"""

from __future__ import annotations

import math

import torch


def layout(meta_params) -> list[tuple[str, tuple]]:
    """(dotted name, shape) of every leaf of a ``meta`` parameter tree."""
    return [(n, tuple(p.shape)) for n, p in meta_params.named_parameters()]


def make(leaves: list, rules: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for each (name, shape) leaf."""
    normal = [(n, s) for n, s in leaves if _rule(rules, n)[0] == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    buf = torch.empty(total, dtype=torch.float32, device=device).normal_(generator=gen)
    out, off = {}, 0
    for n, s in normal:
        k = math.prod(s)
        scale = _rule(rules, n)[1]
        scale = s[0] ** -0.5 if scale == "fan_in" else float(scale)
        out[n] = buf[off:off + k].view(s).mul_(scale)
        off += k
    for n, s in leaves:
        if n in out:
            continue
        kind, *arg = _rule(rules, n)
        if kind == "const":
            out[n] = torch.full(s, float(arg[0]), dtype=torch.float32, device=device)
        elif kind == "log_linspace":
            out[n] = torch.log(torch.linspace(float(arg[0]), float(arg[1]), s[0],
                                              dtype=torch.float32, device=device))
        elif kind == "inv_softplus":
            out[n] = torch.log(torch.expm1(torch.full(s, float(arg[0]), dtype=torch.float32,
                                                      device=device)))
        else:
            raise ValueError(f"unknown init rule {kind!r} for {n}")
    return {n: out[n] for n, _ in leaves}


def _rule(rules: dict, name: str):
    leaf = name.rsplit(".", 1)[-1]
    if leaf not in rules:
        raise KeyError(f"the configuration's init table has no rule for {leaf!r} ({name})")
    return rules[leaf]


def port_params(meta_params, tensors: dict):
    """The port's parameter tree (``models.common.Params``) over ``tensors``
    (shared storage, nothing copied)."""
    from repro_torch.models.common import Params

    name_of = {id(p): n for n, p in meta_params.named_parameters()}
    return Params(meta_params.tree(lambda p: tensors[name_of[id(p)]]))
