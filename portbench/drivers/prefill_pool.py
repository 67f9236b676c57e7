"""Prefill traffic: a closed loop of forwards through the port's bulk
prefill (``training.step.make_serve_steps``' ``prefill`` ->
``models.lm.lm_prefill``), the prefill instance of a disaggregated
deployment.

Set-up makes the weights, builds the serve step and runs one forward of
each length the mix can draw.  The window dispatches forwards from the
traffic generator until ``--seconds`` have passed (a traced run traces its
second half); a request's time to first
token runs from its forward's dispatch to its last-position logits on the
host.  A seeded reservoir keeps a few served requests (their prompts,
logits and caches) and always the first of the longest length; once the
window has closed and the port's state is freed, the plain float32
reference runs each kept prompt alone and the comparisons decide
``correct``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import harness, weights as wmod
from portbench.gen import traffic as tgen
from portbench.reference import lm as ref
from portbench.trace import DeviceTrace, Record, Spans, window_parts


class Kept(NamedTuple):
    """One served request held for the comparison."""

    forward: int  # the forward's index
    tokens: torch.Tensor  # [L]
    logits: torch.Tensor  # [vocab] float32, host
    caches: list  # per layer, a tuple of the request's cache tensors


def _keep(fwd, pos, tokens, host_logits, caches):
    return Kept(fwd.index, tokens[pos].clone(), host_logits[pos].clone(),
                [tuple(t[pos].clone() for t in c) for c in caches])


def compare(kept: list, weights: dict, port: dict) -> tuple[dict, dict]:
    """The numbers compared: the worst relative gap of the last-position
    logits and of any layer's cache tensor.  Beside them, not compared, the
    widest gap by which the served greedy token's reference logit lies below
    the reference's best (in units of the reference logits' standard
    deviation): the float8 control reads 0 on some seeds, so it sets no
    upper reading."""
    logits_rel = cache_rel = token_gap = 0.0
    for k in kept:
        r_logits, r_caches = ref.prefill(weights, port, k.tokens[None])
        r = r_logits[0].float().cpu()
        logits_rel = max(logits_rel, harness.rel_gap(k.logits, r))
        served = int(torch.argmax(k.logits))
        token_gap = max(token_gap, float((r.max() - r[served]) / r.std()))
        for mine, theirs in zip(k.caches, r_caches):
            for a, b in zip(mine, theirs):
                cache_rel = max(cache_rel, harness.rel_gap(a.float(), b[0].float()))
        del r_logits, r_caches
    return {"logits_rel": logits_rel, "cache_rel": cache_rel}, {"token_gap": token_gap}


def run(cell, args, device, tiny: bool = False) -> harness.Outcome:
    from repro_torch.models import build
    from repro_torch.training.step import make_serve_steps

    p = harness.traffic_params(cell.traffic, tiny)
    cfg = harness.arch(cell.config, tiny)
    port = harness.port_fields(cell.config, tiny)
    api = build(cfg)
    meta = api.init(None, torch.device("meta"))
    leaves = wmod.layout(meta)
    w = wmod.make(leaves, cell.config["init"], args.seed, device)
    params = wmod.port_params(meta, w)
    prefill, _ = make_serve_steps(cfg, api)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_weights = harness.process_age_s()
    seeds = tgen.seed_seq(args.seed, 2).generate_state(2)
    warm_gen = torch.Generator(device=device).manual_seed(int(seeds[0]))
    gen = torch.Generator(device=device).manual_seed(int(seeds[1]))
    pick = np.random.default_rng(tgen.seed_seq(args.seed, 4))

    with torch.no_grad():
        for L in tgen.lengths(p):  # every shape the window can use
            toks = torch.randint(0, cfg.vocab, (tgen.batch_of(p, int(L)), int(L)),
                                 generator=warm_gen, device=device)
            logits, _ = prefill(params, {"tokens": toks})
            logits.cpu()
        del logits, toks
    if device.type == "cuda":
        torch.cuda.synchronize()

    ttft, kept, longest = [], [], None
    n_keep = int(cell.limits["sample"])
    max_len = int(tgen.lengths(p)[-1])
    tokens_done = failed = n_forwards = 0
    forwards = tgen.forwards(p, args.seed)
    host = (Spans(), 0.0, [])  # the untraced part's spans, wall and forwards
    setup_s = harness.process_age_s()
    t_start = time.perf_counter()
    t_end = t_start
    with torch.no_grad():
        for until, traced in window_parts(args.seconds, bool(args.trace)):
            spans, items = Spans(traced=traced), []
            with DeviceTrace(traced) as dev:
                t_part = time.perf_counter()
                for fwd in forwards:
                    B = len(fwd.requests)
                    toks = torch.randint(0, cfg.vocab, (B, fwd.length), generator=gen,
                                         device=device)
                    t0 = time.perf_counter()
                    with spans.span("forward"):
                        logits, caches = prefill(params, {"tokens": toks})
                        host_logits = logits[:, -1].float().cpu()
                    t_end = time.perf_counter()
                    ttft += [t_end - t0] * B
                    tokens_done += B * fwd.length
                    n_forwards += 1
                    failed += int((~torch.isfinite(host_logits).all(dim=-1)).sum())
                    items.append({"B": B, "L": fwd.length})
                    with spans.span("keep"):
                        pos = int(pick.integers(B))
                        if fwd.length == max_len and longest is None:
                            longest = _keep(fwd, pos, toks, host_logits, caches)
                        slot = (fwd.index if fwd.index < n_keep
                                else int(pick.integers(fwd.index + 1)))
                        if slot < n_keep:
                            k = _keep(fwd, pos, toks, host_logits, caches)
                            kept[slot:slot + 1] = [k]
                    del logits, caches
                    if t_end - t_start >= until:
                        break
                part_s = t_end - t_part
            if not traced:
                host = (spans, part_s, items)
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del params, prefill
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sample = kept + ([longest] if longest is not None and
                     longest.forward not in {k.forward for k in kept} else [])
    t_ref = time.perf_counter()
    with torch.no_grad():
        values, seen = compare(sample, w, port)
    seen["reference_s"] = time.perf_counter() - t_ref
    seen["weights_ready_s"] = t_weights
    out = harness.Outcome(
        attempted=len(ttft), failed=failed,
        metrics={"prefill_tokens_per_s": tokens_done / window_s,
                 "ttft_p95_ms": 1e3 * harness.quantile(ttft, 0.95)},
        checks=harness.checks_from(values, cell.limits["limits"]),
        memory_peak_bytes=peak,
        notes={"forwards": n_forwards, "window_s": window_s, "setup_s": setup_s,
               "ttft_p50_ms": 1e3 * harness.quantile(ttft, 0.5),
               "compared": [(s.forward, int(s.tokens.shape[0])) for s in sample], **seen})
    if args.trace:
        out.record = Record(part_s, dev.device_ops, dev.host_ranges, items, host[1],
                            dict(host[0].spans), dict(host[0].counters), host[2],
                            cell.config, p, port)
    return out
